"""Host seconds of the compile's bell relabel, bell_order and
apply_reorder (CompiledModel.lower_spans `gala.lower.relabel`)."""
from gala_bench import spans


def read(run):
    return spans.lower_stage_s(run, "gala.lower.relabel")
