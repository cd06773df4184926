"""Top-level compile API (the port of gala_tpu.api).

One Python entry point covers the reference's command-line programs;
their differences are keyword options of `lower` (mode, strategy,
device...).  Every entry point runs on the card unless the caller passes
device="cpu".  Graph sampling (data, static and dynamic kernel level)
comes from the program's own DSL lines, as in gala_tpu; no option here.
"""
from __future__ import annotations


def compile_source(source: str, device="cuda", **opts):
    """Parse (the port's extensions included: lowering.heads) and compile."""
    from gala_tpu_torch.lowering.heads import parse_source
    from gala_tpu_torch.lowering.lower import lower

    spec = parse_source(source)
    return lower(spec, device=device, **opts)


def compile_file(path: str, device="cuda", **opts):
    with open(path) as f:
        return compile_source(f.read(), device=device, **opts)


def compile_model(spec, device="cuda", **opts):
    """Compile an already-built ModelSpec (Python-embedded DSL path)."""
    from gala_tpu_torch.lowering.lower import lower

    return lower(spec, device=device, **opts)
