"""The dry run over the other five architectures of the zoo at smoke size: every
(architecture x shape) cell on a fake (2, 2, 2) mesh ends ``ok``, or
``skipped`` exactly where ``shapes.cell_supported`` says (``long_500k``
on the full-attention architectures).  The ten architectures are split
over two files (``test_torch_launch_zoo_a.py`` / ``_b.py``) so that
each stays near a minute on one worker.
"""
from __future__ import annotations

import pytest

from repro_torch import configs
from repro_torch.launch import shapes

from test_torch_launch import smoke_record

ARCHS = configs.all_archs()[5:]


@pytest.mark.parametrize("shape", list(shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_ends_ok_or_skipped_where_unsupported(arch, shape):
    rec = smoke_record(arch, shape)
    supported, _ = shapes.cell_supported(arch, shape)
    if not supported:
        assert rec["status"] == "skipped", rec
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["flops"] > 0 and rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["roofline"]["bound_s"] > 0
