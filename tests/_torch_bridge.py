"""Numpy bridge between the JAX package and its PyTorch port for the
`test_torch_*.py` files: the same values as uint32 arrays (JAX) and int32
tensors on the CPU (port)."""

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the module's tests with one intra-op torch thread and in
    `torch.inference_mode` (import this fixture into a test module to apply
    it). The plain versions run long chains of tiny tensor ops: on a CPU
    shared with other test workers the intra-op thread pool makes them many
    times slower (a Stark `DLCards` setup at (2, 2): 6 s on one thread,
    213 s on eight beside a JAX compile), and inference mode skips the
    autograd bookkeeping of every op (the port never differentiates), about
    a sixth of a plain point addition's time."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(before)


def dense_below_p(p: int, L: int) -> int:
    """The largest value below p whose limbs under the top one are all 0xFFFF
    (the densest reduced operand for the plain limb arithmetic)."""
    return ((p >> (16 * (L - 1))) << (16 * (L - 1))) - 1


def to_torch(a) -> torch.Tensor:
    """JAX/numpy limb array (uint32) or bool array -> CPU tensor (int32/bool)."""
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.as_tensor(a.copy())
    return torch.as_tensor(a.astype(np.int64)).to(torch.int32)


def to_np(t) -> np.ndarray:
    """Port tensor -> numpy (limbs as uint32, flags as bool)."""
    a = t.detach().cpu().numpy()
    return a if a.dtype == bool else a.astype(np.uint32)


def leaves(tree) -> list:
    """Leaves of a NamedTuple tree, in field order (the order jax.tree uses)."""
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in leaves(t)]
    return [tree]


def rebuild(template, flat):
    """A tree shaped like `template` (NamedTuples) with the given leaves."""
    it = iter(flat)

    def go(t):
        if isinstance(t, tuple):
            return type(t)(*(go(c) for c in t))
        return next(it)

    return go(template)


def to_jax_tree(tree):
    """A port NamedTuple tree as the JAX package's NamedTuples of the same
    names, with numpy leaves (so JAX programs see their own pytree types)."""
    from mental_poker_tpu.arguments import device as jdev
    from mental_poker_tpu.crypto import elgamal as jelgamal
    from mental_poker_tpu.ops import curve as jcurve

    if isinstance(tree, tuple):
        name = type(tree).__name__
        cls = getattr(jdev, name, None) or getattr(jelgamal, name, None) or getattr(jcurve, name)
        return cls(*(to_jax_tree(t) for t in tree))
    return to_np(tree)
