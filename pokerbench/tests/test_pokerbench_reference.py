"""The reference against the port's CPU path at small sizes, through the
whole harness (the look for a card skipped): a sound run is correct, and
the control and every planted fault that the cell can have make it not
correct. The comparisons run at the cells' own sizes on the card
(`python3 -m pokerbench.faults`, and the `cuda` test below)."""

import json
import shutil

import pytest
import torch

from pokerbench import faults, run

SIZES = {
    # (2, 4) decks, two a batch; 4-bit fixed-base windows keep the CPU set-up short
    "shuffle52.table": ({"m": 2, "n": 4, "fixed_window_bits": 4},
                        {"batch": 2, "fuse_b_max": 2, "statements": 1, "pool": 16, "kept_per_call": 2,
                         "reference_proofs": 2}),
    # two games of three players, two cards each
    "game8p.batch": ({"m": 1, "n": 2, "players": 3, "fixed_window_bits": 4},
                     {"games": 2, "pool": 8, "kept_per_call": 2, "reference_cards": 2}),
}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(run.ROOT / "pokerbench", root / "pokerbench")
    shutil.copy(run.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = run.manifest(root)
    for cell, (conf, traffic) in SIZES.items():
        wl, _, _ = run.cell(bench, cell, root)
        cpath = root / next(c["file"] for c in bench["configs"] if c["name"] == wl["config"])
        tpath = root / "pokerbench" / "workloads" / f"{cell}.json"
        for path, upd in ((cpath, conf), (tpath, traffic)):
            d = json.loads(path.read_text())
            d.update(upd)
            path.write_text(json.dumps(d))
    return root


def _run(root, cell, seed, fault=None):
    torch.set_num_threads(1)
    driver = "shuffle" if cell.startswith("shuffle") else "multigame"
    with torch.inference_mode():
        if fault is None:
            return run.run_cell(cell, seed, 0.0, False, device="cpu", root=root)
        with faults.planted(driver, fault):
            return run.run_cell(cell, seed, 0.0, False, device="cpu", root=root)


@pytest.mark.parametrize("cell", list(SIZES))
def test_sound_run_is_correct(small_root, cell):
    out = _run(small_root, cell, 2**31 + 12345)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", list(SIZES))
def test_control_and_faults_are_not_correct(small_root, cell, fault):
    out = _run(small_root, cell, 2**31 + 777, fault)
    assert not out["correct"], out["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [(c, f) for c in ("shuffle52.table", "game8p.batch") for f in (None, *faults.FAULTS)
                                        if (c, f) != ("shuffle52.table", "half_batch")])  # a batch of one has no half
def test_cell_size_on_the_card(card, cell, fault):
    """At the cells' own sizes: the sound run correct, the control and the
    faults not."""
    out = run.run_cell(cell, 424242, 2.0, False, device=card) if fault is None else None
    if fault is not None:
        with faults.planted("shuffle" if cell.startswith("shuffle") else "multigame", fault):
            out = run.run_cell(cell, 424242, 2.0, False, device=card)
    assert out["correct"] == (fault is None), out["checks"]
