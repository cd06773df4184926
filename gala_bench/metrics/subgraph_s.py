"""Host seconds of the compile's training subgraphs, mask_subgraphs
(CompiledModel.lower_spans `gala.lower.subgraphs`)."""
from gala_bench import spans


def read(run):
    return spans.lower_stage_s(run, "gala.lower.subgraphs")
