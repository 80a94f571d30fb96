"""Runtime configuration (counterpart of `mental_poker_tpu/config.py`).

`get_config()` reads the environment once into a frozen `RuntimeConfig`;
`set_config()` / `override()` replace it (tests, `chip_smoke.py`). The
environment stays the backing store, under the JAX package's `MPTPU_*` names.

Only the knobs the port reads are kept:

- `msm_nc` (`MPTPU_MSM_NC`, default 1): points per sequential step of the
  per-statement MSM. 1 runs the one-point-per-step kernel (`csrc/msm.cu`);
  above 1 the chunked kernel (`csrc/msm_chunked.cu`) writes window sums that
  the fold kernel folds (`ops/cuda/msm.py::msm_lanes`).
- `fixed_window_bits` (`MPTPU_FIXED_WINDOW`, default 4): the window of the
  fixed-base tables that `DLCards`, its ElGamal and Pedersen schemes and
  `FixedBaseTable` / `FixedBaseMSM` build when no window is given.
- `bench_mode` (`MPTPU_BENCH_MODE`: shuffle52, msm, deck1024 or
  multigame): the mode of the port's bench
  (`python -m mental_poker_tpu_torch.bench`), as in the JAX package. The
  bench's sizes and repetitions are arguments of its mode functions.

The JAX package's TPU knobs (`pallas`, `pallas_msm`, `fuse_b_max`, the
`sol_*` harness, `cache_dir`) have nothing to select here; its per-game
`ProtocolConfig` comes with the first caller that needs it (the parallel
layer).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Process-wide runtime knobs (env-backed, read once)."""

    msm_nc: int = 1  # MPTPU_MSM_NC
    fixed_window_bits: int = 4  # MPTPU_FIXED_WINDOW (the bench sets 8)
    bench_mode: str = "shuffle52"  # MPTPU_BENCH_MODE

    @classmethod
    def from_env(cls) -> "RuntimeConfig":
        d = cls()
        return cls(
            msm_nc=int(os.environ.get("MPTPU_MSM_NC") or d.msm_nc),
            fixed_window_bits=int(os.environ.get("MPTPU_FIXED_WINDOW") or d.fixed_window_bits),
            bench_mode=os.environ.get("MPTPU_BENCH_MODE") or d.bench_mode,
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

