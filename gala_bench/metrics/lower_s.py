"""Seconds of compile_source (lowering, the host layouts), harness clock."""


def read(run):
    return run.lower_s
