"""The reference agrees with the port, and its controls and planted faults
do not: each cell at a tiny size on the CPU (the port's device paths on CPU
tensors, with its kernels' plain versions), and on the card where there is
one."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import answers
from portbench.tests.helpers import CELLS, tiny_parts, tiny_run


@pytest.mark.parametrize("cell", CELLS)
def test_each_answer_of_the_port_equals_the_reference(cell):
    """Request by request, outside the loop: the kind's call into the port
    against the configuration's plain reference."""
    import importlib

    from portbench import loop, run

    bench, cfg, mix = tiny_parts(cell)
    res, _ = tiny_run(cell)  # sets the port's CPU route
    assert res["correct"]
    maker = importlib.import_module(f"portbench.configs.{cfg['maker']}")
    kind = importlib.import_module(f"portbench.kinds.{mix['kind']}")
    dep = maker.load(cfg, maker.draw(cfg, 5, torch.device("cpu")), torch.device("cpu"))
    state = kind.prepare(dep, mix["params"])
    rng = loop.client_rng(5, loop.WINDOW, 0)
    for _ in range(6):
        req = kind.draw(rng, dep, mix["params"])
        assert answers.off_by(kind.expected(dep, mix["params"], req), kind.call(state, req)) == 0
    assert run.forbidden_modules() == []


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct(cell):
    res, lines = tiny_run(cell, seconds=2.0)
    assert res["correct"], lines
    assert res["failed"] == 0
    assert res["checks"]["compared_answers"]["value"] >= 1


# a control run and a run on the card take the sizes that the cell's maker
# and kind give for them in their tiny files (helpers.py)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(cell):
    res, lines = tiny_run(cell, seconds=1.0, control=True)
    assert not res["correct"], lines
    assert res["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_on_the_card_is_correct_and_its_control_is_not(card, cell):
    res, lines = tiny_run(cell, seconds=2.0, device="cuda")
    assert res["correct"], lines
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
    bad, _ = tiny_run(cell, seconds=1.0, device="cuda", control=True)
    assert not bad["correct"]


def test_answers_compare_sets_by_their_bits_and_counts_exactly():
    import torch

    from roaringbitmap_tpu_torch import RoaringBitmap

    values = np.array([1, 5, 9, 70_000, 130_000], dtype=np.int64)
    mask = torch.zeros(3 * 65536, dtype=torch.bool)
    mask[values] = True
    want = answers.mask_words(mask)
    assert want.shape == (3, 1024)
    assert answers.off_by(want, RoaringBitmap(values)) == 0
    assert answers.off_by(want, RoaringBitmap(values[:-1])) == 1
    assert answers.off_by(want, RoaringBitmap(np.r_[values[:-1], 130_001])) == 2
    assert answers.off_by(want, RoaringBitmap(np.r_[values, 300_000])) == 1  # past the chunks
    assert answers.off_by(want, want.copy()) == 0
    c = np.array([10, 4], dtype=np.int64)
    assert answers.off_by(c, np.array([10, 5])) == 1
    assert answers.off_by(7, 7) == 0 and answers.off_by(7, 9) == 2
    assert answers.off_by(want, 3) >= 1 and answers.off_by(3, RoaringBitmap(values)) >= 1
