"""The port's runtime config (`mental_poker_tpu_torch/config.py`), as
`tests/test_config.py` holds the JAX package's: environment backing under
the same `MPTPU_*` names, `override`, a frozen config, and the knobs'
consumers reading the config; the eighth slice's knobs, `_env_bool` and a
malformed number against the JAX package's config."""

import dataclasses

import pytest

from mental_poker_tpu import config as jconfig
from mental_poker_tpu_torch import config
from mental_poker_tpu_torch.config import RuntimeConfig, get_config, override, set_config


def test_env_backing(monkeypatch):
    monkeypatch.setenv("MPTPU_FIXED_WINDOW", "8")
    monkeypatch.setenv("MPTPU_MSM_NC", "4")
    monkeypatch.setenv("MPTPU_BENCH_MODE", "multigame")
    set_config(None)  # force a re-read
    try:
        cfg = get_config()
        assert cfg.fixed_window_bits == 8
        assert cfg.msm_nc == 4
        assert cfg.bench_mode == jconfig.RuntimeConfig.from_env().bench_mode == "multigame"  # the JAX name
    finally:
        set_config(None)


def test_defaults_match_jax(monkeypatch):
    for k in ("MPTPU_FIXED_WINDOW", "MPTPU_MSM_NC", "MPTPU_BENCH_MODE"):
        monkeypatch.delenv(k, raising=False)
    cfg = RuntimeConfig.from_env()
    jcfg = jconfig.RuntimeConfig.from_env()
    assert cfg.fixed_window_bits == jcfg.fixed_window_bits == 4
    assert cfg.msm_nc == 1  # the JAX package's DEFAULT_NC without MPTPU_MSM_NC
    assert cfg.bench_mode == jcfg.bench_mode == "shuffle52"


def test_override_context():
    base = get_config()
    with override(msm_nc=8) as cfg:
        assert cfg.msm_nc == 8
        assert get_config().msm_nc == 8
    assert get_config().msm_nc == base.msm_nc


def test_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        get_config().msm_nc = 9  # type: ignore[misc]


def test_knob_consumers_route_through_config(monkeypatch):
    from mental_poker_tpu_torch.ops import msm as tmsm
    from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm
    from mental_poker_tpu_torch.protocol.dl_cards import DLCards

    with override(fixed_window_bits=6):
        assert config.window_bits(None) == 6
        assert config.window_bits(4) == 4
        assert DLCards(device="cpu").c == 6
    assert DLCards(device="cpu", c=8).c == 8
    # msm_nc: the split rule and the engine under msm_lanes
    assert tmsm.split_factor(1, 20) == 2
    assert tmsm.split_factor(1, 20, nc=16) == 1  # N >= 2 F max(nc, 8) fails at F = 1
    seen = []
    monkeypatch.setattr(cuda_msm, "msm_chunked", lambda cv, P, k, nc: seen.append(nc) or (None,) * 3)
    monkeypatch.setattr(cuda_msm, "fold_windows", lambda cv, S, c: S)
    with override(msm_nc=4):
        cuda_msm.msm_lanes(None, (None,) * 3, None)
    assert seen == [4]


# The five knobs of the eighth slice and the ninth's fused latency mode:
# (field, variable, a value to set, the parsed value).
NEW_KNOBS = [
    ("stage_timing", "MPTPU_STAGE_TIMING", "1", True),
    ("profile_dir", "MPTPU_PROFILE", "/tmp/trace", "/tmp/trace"),
    ("bench_reps", "MPTPU_BENCH_REPS", "5", 5),
    ("bench_batch", "MPTPU_BENCH_BATCH", "1", 1),
    ("bench_smoke", "MPTPU_BENCH_SMOKE", "true", True),
    ("fuse_b_max", "MPTPU_FUSE_B", "4", 4),
]


@pytest.mark.parametrize("field,var,value,parsed", NEW_KNOBS, ids=[k[0] for k in NEW_KNOBS])
def test_new_knob_env_and_default_match_jax(monkeypatch, field, var, value, parsed):
    monkeypatch.delenv(var, raising=False)
    assert getattr(RuntimeConfig.from_env(), field) == getattr(jconfig.RuntimeConfig.from_env(), field)
    monkeypatch.setenv(var, value)
    assert getattr(RuntimeConfig.from_env(), field) == getattr(jconfig.RuntimeConfig.from_env(), field) == parsed


# `_env_bool` cases: (the variable's value, None for unset; the default).
ENV_BOOL_CASES = [(v, None) for v in ("0", "false", "False", "1", "true", "yes", "")] + [
    (None, d) for d in (True, False, None)
]


@pytest.mark.parametrize("value,default", ENV_BOOL_CASES,
                         ids=[v if v is not None else f"unset-{d}" for v, d in ENV_BOOL_CASES])
def test_env_bool_spellings_match_jax(monkeypatch, value, default):
    """The false spellings, anything else true, and unset or empty giving
    the default, as the JAX package's `_env_bool` reads them."""
    if value is None:
        monkeypatch.delenv("MPTPU_STAGE_TIMING", raising=False)
    else:
        monkeypatch.setenv("MPTPU_STAGE_TIMING", value)
    got = config._env_bool("MPTPU_STAGE_TIMING", default)
    assert got is jconfig._env_bool("MPTPU_STAGE_TIMING", default)
    assert got is (default if value in (None, "") else value not in ("0", "false", "False"))
    assert RuntimeConfig.from_env().stage_timing is (value not in (None, "", "0", "false", "False"))


@pytest.mark.parametrize("var", ["MPTPU_BENCH_REPS", "MPTPU_BENCH_BATCH", "MPTPU_FIXED_WINDOW"])
def test_bad_int_knob_raises_like_jax(monkeypatch, var):
    monkeypatch.setenv(var, "three")
    with pytest.raises(ValueError):
        jconfig.RuntimeConfig.from_env()
    with pytest.raises(ValueError):
        RuntimeConfig.from_env()
