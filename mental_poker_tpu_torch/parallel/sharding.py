"""Multi-rank sharding for batched proving (counterpart of
`mental_poker_tpu/parallel/sharding.py`, same names).

Two mesh dimensions, as in the JAX package:

- ``dp`` (data parallel): independent decks and proofs; no traffic between
  ranks but the final gather.
- ``sp`` (sequence parallel): the deck axis (N = m n cards), or the
  windows of a variable-base MSM (TP). Elementwise card work shards
  freely; a deck-wide MSM computes a partial sum per shard and combines
  the partial points after an all_gather.

The JAX package writes each function as a `shard_map` body; here each one
is three parts:

- a **local step**, a plain function of this rank's shard and its index d
  of D along the mesh dimension;
- the **collective**, an all_gather of the local result over that
  dimension's group (`all_gather_tree`: one `all_gather_into_tensor` of the
  int32 limb tensors packed into one buffer), giving each leaf a leading
  [D] axis in rank order;
- a **combine**, a plain function of the gathered parts.

A `Step` holds the three parts and which input axes split over the ranks.
`on_mesh` composes them for the calling rank (each `sharded_*` returns
it); `run_ranks` runs every rank's local step in one process, one after
another, the gather emulated by stacking in rank order, then the
combines: `chip_smoke.py` and the tests hold the partition arithmetic at
D ranks that way. Outputs are sharded along dp and replicated along sp, as
the JAX package's `out_specs` say.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..arguments.device import leaves, rebuild, tree_map
from ..crypto import elgamal
from ..crypto.elgamal import Ciphertexts
from ..ops import msm as msm_mod
from ..ops.cuda import curve as cuda_curve
from ..ops.curve import Curve, PointP
from .distributed import backend_for, init_distributed

DIMS = ("dp", "sp")


# --------------------------------------------------------------- trees
def stack_trees(trees: list):
    """Trees of one structure -> one tree whose leaves are stacked on a new
    leading axis in list order: what `all_gather_tree` gives a rank, made
    in one process from every rank's local result."""
    cols = zip(*(leaves(t) for t in trees))
    return rebuild(trees[0], [torch.stack(c) for c in cols])


# ---------------------------------------------------------------- mesh
def make_mesh(n_dp: int | None = None, n_sp: int = 1, device="cuda"):
    """A (dp, sp) `DeviceMesh` over every rank of the process group
    (default: all ranks on dp). Joins the launcher's group
    (`init_distributed`) when the environment names one; on one process
    with no launcher it starts a one-rank group over a local store, so the
    same code runs on one card with no environment set. The backend
    follows `device` (NCCL for "cuda", gloo for "cpu")."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    backend = backend_for(device)
    if not dist.is_initialized() and not init_distributed(device):
        if backend == "nccl":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_backend() != backend:
        raise RuntimeError(f"make_mesh: the process group runs {dist.get_backend()}, device {device} needs {backend}")
    world = dist.get_world_size()
    n_dp = n_dp if n_dp is not None else world // n_sp
    if n_dp * n_sp != world:
        raise ValueError(f"make_mesh: dp {n_dp} x sp {n_sp} does not cover the {world} ranks")
    return init_device_mesh(device.type, (n_dp, n_sp), mesh_dim_names=DIMS)


def _dims(dims) -> tuple:
    return (dims,) if isinstance(dims, str) else tuple(dims)


def mesh_index(mesh, dims) -> tuple:
    """(d, D): this rank's index along mesh dimension `dims` and its size;
    a tuple of dimensions reads as one, flattened major to minor ((0, 1)
    for no dimension)."""
    d, D = 0, 1
    for dim in _dims(dims):
        i, n = mesh.get_local_rank(dim), mesh.shape[mesh.mesh_dim_names.index(dim)]
        d, D = d * n + i, D * n
    return d, D


def block(t: torch.Tensor, axis: int, d: int, D: int) -> torch.Tensor:
    """Part d of D equal parts of `t` along `axis`; raises unless D divides
    the axis (as the JAX package's shardings do)."""
    n = t.shape[axis]
    if n % D:
        raise ValueError(f"an axis of {n} does not split into {D} equal shards")
    return t.narrow(axis, d * (n // D), n // D)


def shard_deck(mesh, tree, dims=DIMS):
    """This rank's block of a [B, N, ...] tree (a deck, permutations,
    scalars): axis 0 split over mesh dimension dims[0], axis 1 over
    dims[1]."""
    (i, n), (j, m) = mesh_index(mesh, dims[0]), mesh_index(mesh, dims[1])
    return tree_map(lambda t: block(block(t, 0, i, n), 1, j, m), tree)


def shard_batch(mesh, tree):
    """This rank's rows of a [B, ...] tree with the batch split over dp x sp
    (dp-major, the JAX package's P(("dp", "sp"))): the DP split of
    independent proofs."""
    r, R = mesh_index(mesh, DIMS)
    return tree_map(lambda t: block(t, 0, r, R), tree)


# ---------------------------------------------------------- collectives
def _gather_one(mesh, dim: str, tree):
    import torch.distributed as dist

    flat_leaves = leaves(tree)
    for t in flat_leaves:
        if t.dtype not in (torch.int32, torch.bool):
            raise TypeError(f"all_gather_tree: {t.dtype} leaves do not travel as int32")
    flat = torch.cat([t.reshape(-1).to(torch.int32) for t in flat_leaves])[None]
    group = mesh.get_group(dim)
    D = dist.get_world_size(group)
    out = flat.new_empty((D, flat.shape[1]))
    dist.all_gather_into_tensor(out, flat, group=group)
    parts, lo = [], 0
    for t in flat_leaves:
        parts.append(out[:, lo : lo + t.numel()].reshape((D,) + t.shape).to(t.dtype))
        lo += t.numel()
    return rebuild(tree, parts)


def all_gather_tree(mesh, dims, tree):
    """Every rank's `tree` along mesh dimension `dims` (a name, or a tuple
    read as one dimension, major to minor), each leaf with a leading [D]
    axis in rank order. The leaves (int32 limbs or bool flags) travel as one
    contiguous int32 buffer, one `all_gather_into_tensor` a dimension on its
    group."""
    dims = _dims(dims)
    for dim in reversed(dims):
        tree = _gather_one(mesh, dim, tree)
    return tree_map(lambda t: t.flatten(0, len(dims) - 1), tree)


def cat_parts(tree, axis: int):
    """Gathered parts [D, ...] -> the whole, parts joined along `axis` of the
    local shape."""
    return tree_map(lambda t: torch.cat(t.unbind(0), dim=axis), tree)


def gather_batch(mesh, tree):
    """The whole [B, ...] tree from every rank's `shard_batch` rows (a proof,
    check flags), in batch order, on every rank."""
    return cat_parts(all_gather_tree(mesh, DIMS, tree), axis=0)


# ----------------------------------------------------------------- steps
class Step(NamedTuple):
    """One sharded function in three parts.

    dims: the mesh dimensions the all_gather runs over (empty: none).
    in_axes: per input, the axis its shards split along those dimensions
        (None: every rank holds it whole).
    local(d, D, *shard) -> (kept, sent): rank d of D on its shards; `sent`
        is gathered, `kept` stays on the rank.
    combine(kept, gathered, d) -> the rank's output; `gathered` holds every
        rank's `sent` on a leading [D] axis in rank order (None without a
        collective).
    out_axis: the axis along which the ranks' outputs join into the whole
        (None: every rank's output is the whole).
    """

    dims: tuple
    in_axes: tuple
    local: Callable
    combine: Callable
    out_axis: int | None


def on_mesh(step: Step, mesh, *shard):
    """`step` for the calling rank: its local step on its shards, the
    all_gather, its combine."""
    d, D = mesh_index(mesh, step.dims)
    kept, sent = step.local(d, D, *shard)
    return step.combine(kept, all_gather_tree(mesh, step.dims, sent) if step.dims else None, d)


def run_ranks(step: Step, D: int, *whole, call=lambda fn: fn()):
    """`step` at D ranks in one process, from whole inputs: every rank's
    local step on its shards (block d of D along `in_axes`) in rank order,
    the all_gather emulated by stacking, the combines; the ranks' outputs
    joined along `out_axis` (rank 0's where each is the whole). `call(fn)`
    runs each local step, so that a caller can time it."""

    def shards(d):
        return [x if ax is None else tree_map(lambda t: block(t, ax, d, D), x) for x, ax in zip(whole, step.in_axes)]

    local = [call(lambda: step.local(d, D, *shards(d))) for d in range(D)]
    gathered = stack_trees([sent for _, sent in local]) if step.dims else None
    if step.out_axis is None:
        return step.combine(local[0][0], gathered, 0)
    return cat_parts(stack_trees([step.combine(kept, gathered, d) for d, (kept, _) in enumerate(local)]), step.out_axis)


def batch_step(fn: Callable, n_in: int) -> Step:
    """DP over independent rows: `fn` on each rank's rows of its `n_in`
    [B, ...] inputs (split over dp x sp, as `shard_batch`), the outputs
    gathered in batch order (as `gather_batch`)."""
    return Step(DIMS, (0,) * n_in, lambda d, D, *rows: (None, fn(*rows)),
                lambda _, parts, d: cat_parts(parts, axis=0), None)


# ------------------------------------------------- permute and remask
def _masks(gen_table, pk_table, rho) -> Ciphertexts:
    return Ciphertexts(gen_table.mul(rho), pk_table.mul(rho))


def _permute_add(cv: Curve, deck: Ciphertexts, pi: torch.Tensor, masks: Ciphertexts) -> Ciphertexts:
    idx = pi.long()[..., None]
    permuted = tree_map(lambda t: torch.gather(t, -2, idx.expand(idx.shape[:-1] + t.shape[-1:])), deck)
    return Ciphertexts(cv.add(permuted.c0, masks.c0), cv.add(permuted.c1, masks.c1))


def remask_shuffled_step(cv: Curve, gen_table, pk_table):
    """The one-device shuffle+remask step: (deck [B, N], pi int [B, M],
    rho canonical [B, M, Lk]) -> the deck gathered by pi and remasked,
    [B, M]: out_i = deck[pi_i] + (rho_i G, rho_i pk) through the two
    fixed-base tables."""
    return lambda deck, pi, rho: _permute_add(cv, deck, pi, _masks(gen_table, pk_table, rho))


def remask_step(cv: Curve, gen_table, pk_table) -> Step:
    """(deck, pi, rho) shards along sp: the local step multiplies the
    rank's rho through the fixed-base tables; output card i may come from
    any input shard, so the deck's shards are gathered; the combine gathers
    the whole deck rows by the rank's pi and adds the masks
    (`remask_shuffled_step` split in two)."""
    return Step(("sp",), (1, 1, 1), lambda d, D, deck, pi, rho: ((pi, _masks(gen_table, pk_table, rho)), deck),
                lambda kept, decks, d: _permute_add(cv, cat_parts(decks, axis=1), *kept), 1)


def sharded_remask_step(cv: Curve, gen_table, pk_table, mesh):
    """dp/sp-sharded `remask_shuffled_step`: (deck, pi, rho) blocks
    [B/dp, N/sp] -> this rank's output block."""
    return lambda deck_sh, pi_sh, rho_sh: on_mesh(remask_step(cv, gen_table, pk_table), mesh, deck_sh, pi_sh, rho_sh)


# ------------------------------------------------------------- deck MSM
def deck_msm_step(cv: Curve) -> Step:
    """(c0, c1, k) shards along sp: the shard's partial MSMs (sum_i k_i c0_i,
    sum_i k_i c1_i), 2 points a deck, gathered and summed over the shards."""
    return Step(("sp",), (1, 1, 1),
                lambda d, D, c0, c1, k: (None, elgamal.cipher_msm(cv, Ciphertexts(c0, c1), k)),
                lambda _, parts, d: elgamal.cipher_sum(cv, parts, axis=0), None)


def sharded_deck_msm(cv: Curve, mesh):
    """dp/sp-sharded ciphertext MSM: (c0, c1, k) blocks [B/dp, N/sp] ->
    (sum_i k[b, i] c0[b, i], sum_i k[b, i] c1[b, i]) for this rank's decks
    [B/dp], replicated along sp."""
    return lambda c0, c1, k: on_mesh(deck_msm_step(cv), mesh, c0, c1, k)


# ------------------------------------------------------------ window MSM
def window_split(cv: Curve, D: int) -> tuple:
    """(W, Wd): the windows of a variable-base MSM (c = `FOLD_WINDOW`) and
    the windows each of D ranks owns; the last rank's range may run past W
    into padding."""
    W = -(-cv.fr.bits // cuda_curve.FOLD_WINDOW)
    return W, -(-W // D)


def _window_sums(cv: Curve, pts: PointP, k, d: int, D: int) -> PointP:
    _, Wd = window_split(cv, D)
    return msm_mod.gather_window_sums(cv, pts, k, d * Wd, (d + 1) * Wd)


def _fold_parts(cv: Curve, parts: PointP) -> PointP:
    D, Wd = parts.x.shape[:2]
    W, _ = window_split(cv, D)
    sums = tree_map(lambda t: t.reshape((D * Wd,) + t.shape[2:])[:W], parts)
    return PointP(*cuda_curve.fold_windows(cv, sums, cuda_curve.FOLD_WINDOW))


def window_msm_step(cv: Curve, axis: str = "sp") -> Step:
    """(points [B, N, L], scalars [B, N, Lk]), whole on every rank of
    `axis`: rank d's window sums, windows [d Wd, (d + 1) Wd) ([Wd, B, L]),
    gathered; the windows in order, padding dropped, folded MSB first by
    the fold kernel (acc = 2^c acc + S_w, the JAX package's Horner scan)."""
    return Step((axis,), (None, None), lambda d, D, pts, k: (None, _window_sums(cv, pts, k, d, D)),
                lambda _, parts, d: _fold_parts(cv, parts), None)


def sharded_window_msm(cv: Curve, mesh, axis: str = "sp"):
    """TP-sharded variable-base MSM: (points [B/dp, N, L], scalars
    [B/dp, N, Lk]), replicated along `axis`, -> [B/dp, L]; the Pippenger
    windows split over `axis`."""
    return lambda pts, k: on_mesh(window_msm_step(cv, axis), mesh, pts, k)


# -------------------------------------------------------- prefix product
def _prefix_local(field, a):
    pref = field.prefix_prod(a, axis=1)
    return pref, pref[:, -1]


def prefix_prod_step(field, axis: str = "sp") -> Step:
    """[B, N, L] Montgomery limbs, N split along `axis`: the shard's
    inclusive prefix product and its total; the totals gathered; the
    shard's prefix times the product of the totals of shards 0 to d - 1,
    one `mont_mul` an element."""

    def combine(pref, totals, d):
        offset = field.prod_mod(totals[:d], axis=0)  # Montgomery one for d = 0
        return field.mont_mul(pref, offset[:, None, :])

    return Step((axis,), (1,), lambda d, D, a: _prefix_local(field, a), combine, 1)


def sharded_prefix_prod(field, mesh, axis: str = "sp"):
    """SP: the inclusive modular prefix product of [B, N, L] Montgomery limbs
    along N, with N split over `axis` and B over the other dimension."""
    return lambda a_sh: on_mesh(prefix_prod_step(field, axis), mesh, a_sh)


# -------------------------------------------------------------- commit
def commit_step(ck) -> Step:
    """(vecs [B, m, n, Lk], rs [B, m, Lk]) rows split over dp -> PointP
    [B, m]: the commit key is per game, so each rank commits its own rows
    and no collective runs."""
    return Step((), (0, 0), lambda d, D, vecs, rs: (ck.commit(vecs, rs), None), lambda kept, _, d: kept, 0)


def sharded_commit_step(ck, mesh):
    """dp-sharded Pedersen row commitments, the JAX package's name: (vecs
    [B/dp, m, n, Lk], rs [B/dp, m, Lk]) -> PointP [B/dp, m]. The inputs are
    already this rank's dp rows and nothing is gathered, so this is
    `ck.commit` on them; `mesh` selects nothing."""
    return lambda vecs, rs: on_mesh(commit_step(ck), mesh, vecs, rs)
