"""The fused latency mode (counterpart of the JAX package's
`StagedShuffle._fused`, `mental_poker_tpu/arguments/staged.py:676-690`).

`StagedShuffle.prove` / `.verify` send a batch of 0 < B <= `fuse_b_max`
(`MPTPU_FUSE_B`) proofs here (`run`). Where the JAX package runs the whole
flow as one XLA program, the port runs it as one CUDA graph of the same
kernels and tensor operations that the staged flow launches:

- On the card, the first call at a signature (`_signature`: the flow, the
  curve, (m, n), `msm_nc`, `fixed_window_bits`, `DEBUG_FLAGS`, the device,
  and every input's tree, shape and dtype) copies its inputs into static
  buffers, runs the flow once on a side stream (which builds the kernels,
  loads their modules and fills every constant cache) and captures it into
  a `torch.cuda.CUDAGraph`. Every call copies its inputs into the static
  buffers, replays the graph and returns clones of its outputs, so a later
  call never overwrites a result an earlier call returned. The keys'
  window tables are inputs like the decks and are copied too: a second game
  at the same shapes gets its own proof, and the cache holds no reference
  to a caller's tensors. Each graph keeps its buffers and its memory pool
  for the life of the process (`GRAPHS`).
- On CPU tensors the same flow runs eagerly, with no graph.

While fusing, each challenge is one round of `FUSED_CANDIDATES` draws
(`transcript_dev.sample_field_once`) and the flow counts its undone lanes
on the device (`staged._sample`); the count is read once, after the flow.
If a lane was left undone (about 2^-64 a lane and draw on Stark), the same
inputs run through the staged flow, whose draws loop until every lane is
done, on the same device and kernels, and that result is returned;
`FUSED_MISSES` counts such reruns. Nothing else falls back to the staged
flow: an error in a capture or a replay propagates.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from .. import config
from ..ops.cuda import LAUNCHES
from . import staged
from .device import leaves, rebuild, tree_map

# Fused flows rerun staged because a challenge draw left a lane undone.
FUSED_MISSES = 0


class Captured(NamedTuple):
    """One signature's graph."""

    graph: torch.cuda.CUDAGraph
    inputs: list  # static buffers, one per input leaf in `leaves` order
    outputs: object  # the flow's result tree, in the graph's memory
    undone: torch.Tensor  # int64 []: the lanes the flow's draws left undone
    capture_s: float  # host seconds of the warm-up and the capture
    launches: dict  # kernel launches recorded by the capture, by wrapper (`ops/cuda.LAUNCHES`)


# signature -> Captured
GRAPHS: dict = {}


def _signature(ss, name: str, args) -> tuple:
    cfg = config.get_config()
    return (name, ss.cv.name, ss.m, ss.n, cfg.msm_nc, cfg.fixed_window_bits, staged.DEBUG_FLAGS,
            leaves(args)[0].device, tree_map(lambda t: (tuple(t.shape), t.dtype), args))


def _fusing(flow, args):
    """flow(*args) with one-round draws and no stage timing -> (its result,
    the count of undone lanes as an int64 [] tensor)."""
    staged._FUSING[0] = True
    staged._UNDONE.clear()
    try:
        out = flow(*args)
        undone = torch.cat([u.reshape(-1) for u in staged._UNDONE]).sum()
    finally:
        staged._FUSING[0] = False
        staged._UNDONE.clear()
    return out, undone


def _capture(ss, name: str, flow, args) -> Captured:
    t0 = time.perf_counter()
    dev = leaves(args)[0].device
    with torch.inference_mode(False):  # buffers that any later call may copy into
        inputs = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in leaves(args)]
    for buf, t in zip(inputs, leaves(args)):
        buf.copy_(t)
    static = rebuild(args, inputs)
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _fusing(flow, static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        with torch.cuda.graph(graph):
            outputs, undone = _fusing(flow, static)
    launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    return Captured(graph, inputs, outputs, undone, time.perf_counter() - t0, launches)


def _replay(cap: Captured, args):
    for buf, t in zip(cap.inputs, leaves(args)):
        buf.copy_(t)
    cap.graph.replay()
    return tree_map(torch.clone, cap.outputs), cap.undone


def run(ss, name: str, flow, args):
    """`flow(*args)` fused: replayed from its graph on the card (captured at
    the signature's first call), eager on the CPU; rerun as it is, staged,
    if a draw left a lane undone."""
    global FUSED_MISSES
    if leaves(args)[0].device.type == "cuda":
        key = _signature(ss, name, args)
        cap = GRAPHS.get(key)
        if cap is None:
            cap = GRAPHS[key] = _capture(ss, name, flow, args)
        out, undone = _replay(cap, args)
    else:
        out, undone = _fusing(flow, args)
    if int(undone):
        FUSED_MISSES += 1
        return flow(*args)
    return out
