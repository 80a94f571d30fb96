"""Runtime configuration (counterpart of `mental_poker_tpu/config.py`).

`get_config()` reads the environment once into a frozen `RuntimeConfig`;
`set_config()` / `override()` replace it (tests, `chip_smoke.py`). The
environment stays the backing store, under the JAX package's `MPTPU_*` names
and with its defaults; a boolean reads false for "0", "false" and "False"
(`_env_bool`, as in the JAX package).

Only the knobs the port reads are kept:

- `msm_nc` (`MPTPU_MSM_NC`, default 1): points per sequential step of the
  per-statement MSM. 1 runs the one-point-per-step kernel (`csrc/msm.cu`);
  above 1 the chunked kernel (`csrc/msm_chunked.cu`) writes window sums that
  the fold kernel folds (`ops/cuda/msm.py::msm_lanes`).
- `fixed_window_bits` (`MPTPU_FIXED_WINDOW`, default 4): the window of the
  fixed-base tables that `DLCards`, its ElGamal and Pedersen schemes and
  `FixedBaseTable` / `FixedBaseMSM` build when no window is given.
- `fuse_b_max` (`MPTPU_FUSE_B`, default 0, off): the fused latency mode.
  A staged prove or verify of B proofs with 0 < B <= `fuse_b_max` runs
  its whole flow as one CUDA graph on the card, captured at the first call
  of each signature and replayed after (`arguments/fused.py`); on CPU
  tensors the same flow runs eagerly.
- `stage_timing` (`MPTPU_STAGE_TIMING`, default off): each stage of the
  staged prove and verify is timed to a `torch.cuda.synchronize()` into
  `arguments/staged.py::STAGE_TIMES`, which `stage_report()` reads.
- `profile_dir` (`MPTPU_PROFILE`, default none): the port's bench traces one
  more run with `torch.profiler` and writes a Chrome trace there.
- `bench_mode` (`MPTPU_BENCH_MODE`: shuffle52, msm, deck1024 or
  multigame), `bench_reps` (`MPTPU_BENCH_REPS`, 3 timed runs),
  `bench_batch` (`MPTPU_BENCH_BATCH`, 128 decks of a shuffle52 batch; 1 is
  the single-proof latency mode) and `bench_smoke` (`MPTPU_BENCH_SMOKE`:
  shuffle52 at (m, n) = (2, 4)): the port's bench
  (`python -m mental_poker_tpu_torch.bench`), as in the JAX package.

The JAX package's TPU knobs (`pallas`, `pallas_msm`, the `sol_*` harness,
`cache_dir`) have nothing to select here, nor has the dry
run's time budget (`dryrun_budget_s`), which would skip a tier. Its
per-game `ProtocolConfig` is not kept either: the port's callers take the
curve, (m, n) and the batch as arguments.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os


def _env_bool(name: str, default: bool | None) -> bool | None:
    """The variable as a flag: unset or empty gives `default`; "0", "false"
    and "False" are false; anything else is true."""
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v not in ("0", "false", "False")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Process-wide runtime knobs (env-backed, read once)."""

    msm_nc: int = 1  # MPTPU_MSM_NC
    fixed_window_bits: int = 4  # MPTPU_FIXED_WINDOW (the bench sets 8)
    fuse_b_max: int = 0  # MPTPU_FUSE_B: batches <= this run the whole flow as one CUDA graph
    stage_timing: bool = False  # MPTPU_STAGE_TIMING
    profile_dir: str | None = None  # MPTPU_PROFILE (torch.profiler trace directory)
    bench_mode: str = "shuffle52"  # MPTPU_BENCH_MODE
    bench_reps: int = 3  # MPTPU_BENCH_REPS
    bench_batch: int = 128  # MPTPU_BENCH_BATCH
    bench_smoke: bool = False  # MPTPU_BENCH_SMOKE

    @classmethod
    def from_env(cls) -> "RuntimeConfig":
        d = cls()
        return cls(
            msm_nc=int(os.environ.get("MPTPU_MSM_NC") or d.msm_nc),
            fixed_window_bits=int(os.environ.get("MPTPU_FIXED_WINDOW") or d.fixed_window_bits),
            fuse_b_max=int(os.environ.get("MPTPU_FUSE_B", d.fuse_b_max)),
            stage_timing=bool(_env_bool("MPTPU_STAGE_TIMING", d.stage_timing)),
            profile_dir=os.environ.get("MPTPU_PROFILE") or None,
            bench_mode=os.environ.get("MPTPU_BENCH_MODE") or d.bench_mode,
            bench_reps=int(os.environ.get("MPTPU_BENCH_REPS") or d.bench_reps),
            bench_batch=int(os.environ.get("MPTPU_BENCH_BATCH") or d.bench_batch),
            bench_smoke=bool(_env_bool("MPTPU_BENCH_SMOKE", d.bench_smoke)),
        )


_config: RuntimeConfig | None = None


def get_config() -> RuntimeConfig:
    global _config
    if _config is None:
        _config = RuntimeConfig.from_env()
    return _config


def set_config(cfg: RuntimeConfig | None) -> None:
    """Replace the process config (None: re-read the environment on next access)."""
    global _config
    _config = cfg


@contextlib.contextmanager
def override(**kwargs):
    """Temporarily override config fields."""
    old = get_config()
    set_config(dataclasses.replace(old, **kwargs))
    try:
        yield get_config()
    finally:
        set_config(old)


def window_bits(c: int | None) -> int:
    """`c`, or the configured fixed-base window when it is None."""
    return get_config().fixed_window_bits if c is None else c
