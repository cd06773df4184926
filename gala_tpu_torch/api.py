"""Top-level compile API (the port of gala_tpu.api).

One Python entry point covers the reference's command-line programs;
their differences are keyword options of `lower` (mode, strategy,
device...).
"""
from __future__ import annotations


def compile_source(source: str, **opts):
    from gala_tpu_torch.dsl.parser import parse_source
    from gala_tpu_torch.lowering.lower import lower

    spec = parse_source(source)
    return lower(spec, **opts)


def compile_file(path: str, **opts):
    with open(path) as f:
        return compile_source(f.read(), **opts)


def compile_model(spec, **opts):
    """Compile an already-built ModelSpec (Python-embedded DSL path)."""
    from gala_tpu_torch.lowering.lower import lower

    return lower(spec, **opts)
