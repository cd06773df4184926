"""Host seconds of the compile's layouts: every Graph.from_host, the
full graph and the training subgraphs (CompiledModel.lower_spans
`gala.lower.layout`)."""
from gala_bench import spans


def read(run):
    return spans.lower_stage_s(run, "gala.lower.layout")
