"""Hand-written Hopper kernels (counterpart of `mental_poker_tpu/ops/pallas/`).

Each module holds one kernel's wrapper beside its plain PyTorch version:

- `field.py`: Montgomery multiply (replaces `ops/pallas/field.py::_mont_mul_kernel`);
- `curve.py`: complete point addition (replaces `ops/pallas/curve.py::_add_kernel`)
  and the window fold of the gather MSM engine (replaces
  `ops/pallas/curve.py::_fold_kernel`);
- `msm.py`: per-statement MSM (replaces `ops/pallas/msm.py::_msm_kernel`)
  and its chunked form, NC points per step with the window sums out
  (replaces `ops/pallas/msm.py::_msm_kernel_chunked`);
- `hash.py`: the transcript's Blake2s and its ChaCha20 challenge draw
  (replace no Pallas kernel: jnp code in `crypto/hash_jax.py`); their plain
  versions are in `crypto/hash_dev.py` and `crypto/transcript_dev.py`.

The CUDA C++ sources are in `mental_poker_tpu_torch/csrc/`; `build.py`
compiles them with nvcc for sm_90a at first use and binds them with ctypes.

`LAUNCHES` counts, per kernel, the wrapper calls that launched it on the
card (plain-version calls on CPU tensors do not count). Callers that want
the count of one run set the entries to 0 first.
"""

LAUNCHES = {"mont_mul": 0, "point_add": 0, "msm_lanes": 0, "fold_windows": 0, "msm_chunked": 0,
            "blake2s": 0, "chacha_draw": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
