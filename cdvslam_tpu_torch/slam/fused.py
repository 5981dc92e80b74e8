"""The steady-state step as one CUDA graph replay (port of the JAX
runtime's one-dispatch frame: ``cdvslam_tpu/slam/runtime.py``
``_call_fused`` -> ``_fused_frame_update`` -> ``_build_fused``).

In the JAX package every initialized frame is one dispatch of one compiled
program over padded, static shapes: the deferred keyframe shift, the frame
insert and the update, with the state buffers donated and every per-frame
value a traced argument (then, with a depth head, the scale adjustment as a
compiled call of its own). Here that program is ``fused_body``, with the
scale adjustment as its last stage, and its
compiled form is a ``torch.cuda.CUDAGraph`` captured once per static key
(``FusedKey``: the padded edge count, the patch window, the BA iterations,
the shift span, the network and its type), into one shared memory pool,
after one eager warm-up run of the body on a copy of the state on a side
stream. The SLAM's state buffers are written in place (``PatchGraph.
state``); a frame's inputs are copied into its key's static buffers before
each replay (``FrameInputs``: the image, one int32 block of edge indices
and scalars, one float64 block of intrinsics, the motion factor and the
random draws), and its outputs (mm, dP) are overwritten by the next
replay, so the caller copies what it keeps.

On the CPU (``device="cpu"``) ``FusedStep.run`` runs ``fused_body``
eagerly. On the card every steady-state frame is one replay; a capture or
a replay that fails raises (nothing falls back to the eager body). A key
whose state buffers moved (``PatchGraph._grow``) is captured again.

Launch counts: a kernel wrapper counts its Python calls, and a replay
makes none. ``FusedStep`` takes what the wrappers counted while a key was
captured as the launches of one replay of it, and adds them at each
replay; the warm-up run is not the path's work and counts nothing. The
tracer's device stamps (``utils.trace``, ``ops.stamp``) are kernels of the
graph like the others and count under their own counter
(``ops.stamp.LAUNCHES``), never under the corr or attention counts.

Device stamps: ``fused_body`` stamps its start, the end of the keyframe
shift and, through ``SLAM._insert_frame`` and ``kernels.update_body``, the
end of the networks, of the frame's writes and of the update operator,
then its end, which moves the tracer's ring to its next row. With heads it
also stamps each side of SCORE's selection, of the chosen patches' seg
class and of the depth head's part, and the start of the scale
adjustment (``utils.trace.row_stages``). Captured, they replay with the
graph; the warm-up stamps nothing. After each replay ``FusedStep`` names
the row and its stages for the tracer (``row_done``). The heads' device
tallies (``SLAM._count``) replay with the graph in the same way.
"""
from __future__ import annotations

import gc
import time
from typing import NamedTuple, Optional

import torch

from ..ops import native
from .kernels import SCALARS, shift_rows


class FusedKey(NamedTuple):
    """The static part of a step: one graph per key."""
    E_pad: int           # padded edge count (``PatchGraph.bucket``)
    KWIN: int            # patch-window rows
    iterations: int      # local BA iterations (0 when a global BA follows)
    shift_span: int      # rows a deferred keyframe removal moves (0: none)
    network: str
    dtype: torch.dtype   # the networks' type


class FrameInputs(NamedTuple):
    """A step's inputs on the device."""
    image: Optional[torch.Tensor]   # (H, W, 3) uint8
    ints: torch.Tensor              # int32: kernels.BLOCK_ROWS x E_pad, then kernels.SCALARS
    floats: Optional[torch.Tensor]  # float64: see SLAM._host_floats


def fused_body(slam, st, inp: FrameInputs, key: FusedKey):
    """The steady-state step of ``slam`` on the state dict ``st``: the
    deferred keyframe shift (when ``key.shift_span``), the frame insert, one
    update and, with a depth head and no global BA to follow (``key.
    iterations``), the scale adjustment over frames [t0, n + 1) of the
    step's scalars. Returns (mm, dP): the keyframe motion magnitudes (2,)
    and the removed frame's relative pose, or None."""
    stamp = slam._stamp
    stamp(0)
    dP = None
    if key.shift_span:
        k = inp.ints[len(inp.ints) - len(SCALARS) + SCALARS.index("shift_k")].long()
        dP = shift_rows(st, k, key.shift_span, slam.M)
    stamp(1)
    slam._insert_frame(st, inp, True)
    mm = slam._update_step(st, inp, key)
    if key.iterations and slam.depth_head is not None:
        stamp(14)
        tail = inp.ints[len(inp.ints) - len(SCALARS):].long()
        slam._adjust_scale(st, tail[SCALARS.index("t0")], tail[SCALARS.index("n")] + 1)
    stamp(5, advance=True)
    return mm, dP


class Captured:
    """One key's graph, its static inputs and outputs, the state addresses
    it was captured on, the launches of one replay and its replays."""

    def __init__(self, graph, inputs, outputs, ptrs, launches):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.ptrs, self.launches = ptrs, launches
        self.replays = 0


class FusedStep:
    """The steady-state step of one SLAM: eager on the CPU, one CUDA graph
    replay per frame on the card."""

    def __init__(self, slam):
        self.slam = slam
        self.graphs = {}          # FusedKey -> Captured
        self.pool = None          # the graphs' shared memory pool
        self.captures = 0
        self.replays = 0
        self.off_path = False     # True while the warm-up runs the body

    def run(self, key: FusedKey, frame, ints, floats):
        """The step of one frame: ``frame`` the image on the device, ``ints``
        and ``floats`` the host blocks. Returns (mm, dP)."""
        slam = self.slam
        st = slam.pg.state()
        captures, launched = self.captures, None
        if slam.device.type != "cuda":
            inp = FrameInputs(frame, torch.from_numpy(ints), torch.from_numpy(floats))
            out = fused_body(slam, st, inp, key)
        else:
            ptrs = tuple(t.data_ptr() for t in st.values())
            g = self.graphs.get(key)
            if g is None or g.ptrs != ptrs:
                self.graphs.pop(key, None)
                g = self._capture(key, st, ptrs, frame, ints, floats)
            else:
                self._fill(g.inputs, frame, ints, floats)
            launched = time.perf_counter_ns()
            self.replay(g)
            out = g.outputs
        slam.trace.row_done("replay", slam.pg.counter - 1, steady=self.captures == captures,
                            prefetched=slam._prefetched_frame, launch_ns=launched,
                            stages=slam._row_stages("replay", key))
        return out

    @staticmethod
    def _fill(inputs: FrameInputs, frame, ints, floats):
        """Copy a frame's inputs into a key's static buffers (the host
        blocks through pinned memory, without waiting)."""
        inputs.image.copy_(frame)
        inputs.ints.copy_(torch.from_numpy(ints).pin_memory(), non_blocking=True)
        inputs.floats.copy_(torch.from_numpy(floats).pin_memory(), non_blocking=True)

    def replay(self, g: Captured):
        """One replay of a captured key, counted as its launches."""
        g.graph.replay()
        g.replays += 1
        self.replays += 1
        for counter, n in g.launches.items():
            counter.count += n

    def _capture(self, key, st, ptrs, frame, ints, floats) -> Captured:
        slam, dev = self.slam, self.slam.device
        inputs = FrameInputs(torch.empty_like(frame),
                             torch.empty(ints.shape, dtype=torch.int32, device=dev),
                             torch.empty(floats.shape, dtype=torch.float64, device=dev))
        self._fill(inputs, frame, ints, floats)
        counts = [c.count for c in native.COUNTERS]
        # the warm-up (lazy library loads, kernel attributes, library
        # handles and workspaces): the same body on a copy of the state
        self.off_path = True
        try:
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                fused_body(slam, {k: v.clone() for k, v in st.items()}, inputs, key)
            main.wait_stream(side)
        finally:
            self.off_path = False
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = [c.count for c in native.COUNTERS]
        # no garbage collection while capturing: collecting a dead SLAM's
        # graphs frees their pool (cudaFree), which invalidates a capture
        # in progress. thread_local: other threads (a reader thread's
        # uploads, the classical backend's PGO worker) keep running.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                outputs = fused_body(slam, st, inputs, key)
        finally:
            if collecting:
                gc.enable()
        launches = {c: c.count - b for c, b in zip(native.COUNTERS, before) if c.count != b}
        for c, n in zip(native.COUNTERS, counts):
            c.count = n
        self.captures += 1
        g = Captured(graph, inputs, outputs, ptrs, launches)
        self.graphs[key] = g
        return g

    def pool_bytes(self):
        """Bytes of the device memory segments of the graphs' pool (None
        when the allocator's snapshot does not name pools)."""
        if self.pool is None:
            return 0
        segs = torch.cuda.memory_snapshot()
        if segs and "segment_pool_id" not in segs[0]:
            return None
        return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) == tuple(self.pool))
