"""The port's tracer: where a frame's host time goes, what the device did
inside each CUDA graph replay, and how long the device sat idle between
two replays and under which host phase.

Host spans. ``rec.span(name, frame=None, **attrs)`` is a context manager:
a span is its name, its start and end on the host clock
(``time.perf_counter_ns``), its parent span, the frame it belongs to (given
on the outermost span, inherited by the spans inside it), the record's id
and the thread. A span's self time is its length less its child spans'.
``span(name)`` at module level records into the process's record
(``TRACER.process``), for work that belongs to no SLAM (the frame reader).

Records. One ``Record`` per SLAM, made by ``new_record`` in construction
order. It keeps, in memory, per span name: the count, the total and the
self nanoseconds, over the SLAM's whole life (``totals``) and over its
steady frames alone (``steady``; a steady frame is an outermost ``frame``
span closed with ``steady=True``: an initialised SLAM that captured no
graph), and ``steady_frames``; the SLAM's counters (its ``stats`` dict);
the device stages and gaps below; and the clock. A record whose SLAM
reached ``terminate()`` (``end()``) outlives the SLAM: the newest
KEEP_ENDED such records are kept, so that a run's sequences can be summed
(``ended()``). A record whose SLAM is freed before ``terminate()`` goes.

Raw spans. The last RING_SPANS closed spans of the process (every record
and thread) are kept in ``TRACER.spans`` in closing order, as tuples
``(id, name, start_ns, end_ns, parent id, frame, record id, thread id,
attrs)``; the last RING_ROWS device rows in ``TRACER.rows`` (see
``Row``). Nothing is written out: callers read these.

Device stamps. On the card, ``rec.stamp(slot, advance)`` launches a
one-thread kernel (``ops.stamp``) that writes the device's global timer
into the record's ring of RING_DEVICE rows of SLOTS slots, at row
``cursor % RING_DEVICE``; ``advance`` writes the cursor (the row's sequence
number) into the row's last slot and moves it (a device int64) on.
Inside a CUDA graph capture the stamp becomes a node of the graph, so it
runs at every replay and writes a new row each time, and no input of the
graph changes. The steady step stamps: replay start (slot 0), after the
keyframe shift (1), after the networks (2), after the frame's writes (3),
after the update operator (4), the step's end (5, advancing); the frame's
upload writes slots 6 and 7 before and after it. The stages of a replay
are ``shift`` 0-1, ``features`` 1-2, ``patches`` 2-3, ``update`` 3-4,
``ba`` 4-5 and ``upload`` 6-7. An eager insert before the initialisation
stamps 0, 2, 3, 5 (``features`` 0-2, ``patches`` 2-3) and an eager update
0, 4, 5 (``update`` 0-4, ``ba`` 4-5). A SLAM with heads stamps more
(``row_stages``): SCORE's selection 8-9 and the chosen patches' seg class
10-11 (together ``select``), the depth head's map, its resize and the new
patches' inverse depths 12-13 (``depth``), all inside ``features``; and in
a replay that runs the scale adjustment, its start 14: ``ba`` is then 4-14
and ``scale`` 14-5. The caller names each row it completes and, where
they are not its kind's, its stages (``row_done``); a row whose sequence
number is not the one the host expects (a stamp ran that no ``row_done``
named) is dropped and counted in ``lost_rows``. Every DRAIN_EVERY rows the
ring is copied into pinned host memory without waiting, behind the work on
the stream; a copy is read once its event has passed (``collect``, at
points where the host has already waited for later work) and at
``terminate()`` (``flush``). A row overwritten before it was read counts
in ``lost_rows``. On the CPU
the stamps write the host clock into a host ring at once.

One clock. At construction the device timer's offset from the host clock
is taken from ``CLOCK_TRIALS`` stamps, each launched and waited for: the
tightest round trip gives the offset, half of it the error bound
(``clock``: ``offset_ns``, ``error_ns``, the timer's observed
``resolution_ns``). The two clocks drift apart by a few parts per million:
at ``end()`` the offset is measured again (``drift_ns``, its change over
the SLAM's life), and the next record on the device starts from that rate
(``rate_ppm``; a life under 10 s gives none). While rows are read the
offset is also kept inside the band that causality allows, at no wait of
its own: a replay's first stamp is no earlier than the host's call that
launched it (``row_done``'s ``launch_ns``), and its last stamp no later
than the host's return from the wait on that frame (``observed``);
``tracked_ns`` is how far this moved the offset. For each steady replay the device gap is its first
stamp less the previous replay's last: the idle time between two frames'
graphs (it includes the frame's input copies). The gap is charged to the
innermost span of this record that ran at the gap's midpoint on the host
clock ("outside" when none did), in ``gaps``; ``stages`` sums the steady
replays' stages, ``replay`` their first-to-last stamp.

Off. ``OFF`` (a SLAM made with ``trace=False``) records nothing: its
``span()`` returns one shared no-op span and its stamps launch nothing, so
captured graphs hold no stamp node.
"""
from __future__ import annotations

import functools
import itertools
import statistics
import threading
import time
import weakref
from collections import deque
from typing import NamedTuple, Optional

import numpy as np

KEEP_ENDED = 64          # records kept after their SLAM reached terminate()
RING_SPANS = 16384       # raw spans kept, process-wide
RING_ROWS = 4096         # raw device rows kept, process-wide
RING_DEVICE = 64         # rows of a record's device ring
SLOTS = 16               # a row: 15 stamps, then its sequence number
DRAIN_EVERY = 4          # rows between two copies of the device ring
CLOCK_TRIALS = 20

# slots each kind of row stamps, and its stages as (name, from slot, to slot)
KINDS = {
    "replay": ((0, 1, 2, 3, 4, 5, 6, 7),
               (("shift", 0, 1), ("features", 1, 2), ("patches", 2, 3), ("update", 3, 4),
                ("ba", 4, 5), ("upload", 6, 7))),
    "insert": ((0, 2, 3, 5, 6, 7), (("features", 0, 2), ("patches", 2, 3), ("upload", 6, 7))),
    "update": ((0, 4, 5), (("update", 0, 4), ("ba", 4, 5))),
}


@functools.lru_cache(maxsize=None)
def row_stages(kind, select=False, seg=False, depth=False, scale=False):
    """The stages of a row of ``kind`` with the heads' stamps: SCORE's
    selection (``select``) and the seg class (``seg``), both counted as
    stage ``select``, the depth head (``depth``) and, in a replay, the scale
    adjustment after the BA (``scale``); None where there are none (the
    kind's own stages)."""
    if not (select or seg or depth or scale):
        return None
    stages = list(KINDS[kind][1])
    if scale:
        stages[stages.index(("ba", 4, 5))] = ("ba", 4, 14)
        stages.append(("scale", 14, 5))
    stages += [s for on, s in ((select, ("select", 8, 9)), (seg, ("select", 10, 11)),
                               (depth, ("depth", 12, 13))) if on]
    return tuple(stages)


_now = time.perf_counter_ns
_local = threading.local()
_ids = itertools.count(1)


class _Thread:
    """This thread's open spans and its id."""
    __slots__ = ("stack", "tid")

    def __init__(self):
        self.stack, self.tid = [], threading.get_ident()


def _thread():
    try:
        return _local.th
    except AttributeError:
        _local.th = _Thread()
        return _local.th


class Row(NamedTuple):
    """One device row, on the host clock."""
    record: int                 # the record's id
    kind: str                   # "replay", "insert" or "update"
    frame: Optional[int]        # the SLAM's frame counter when the row was made
    steady: bool                # a steady frame's replay
    prefetched: Optional[bool]  # the frame's upload was prefetched (None: no upload)
    start_ns: int               # first and last compute stamp (slots 0 and 5)
    end_ns: int
    stages: dict                # stage name -> ns (a name's intervals summed)


class Span:
    """An open span (see the module docstring)."""
    __slots__ = ("rec", "name", "frame", "attrs", "sid", "t0", "child", "parent", "root",
                 "desc", "th")

    def __init__(self, rec, name, frame, attrs):
        self.rec, self.name, self.frame, self.attrs = rec, name, frame, attrs

    def set(self, **attrs):
        self.attrs.update(attrs)

    def rename(self, name):
        self.name = name

    def __enter__(self):
        self.th = th = _thread()
        stack = th.stack
        parent = stack[-1] if stack else None
        self.parent = parent
        self.root = None if parent is None else (parent.root or parent)
        if self.frame is None and parent is not None:
            self.frame = parent.frame
        self.desc = [] if parent is None else None
        self.child = 0
        self.sid = next(_ids)
        stack.append(self)
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        t1 = _now()
        self.th.stack.pop()
        self.rec._close(self, t1)
        return False


class _NoSpan:
    """The shared span of a record that is off."""
    __slots__ = ()

    def set(self, **attrs):
        pass

    def rename(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOSPAN = _NoSpan()


class Record:
    """What the tracer keeps of one SLAM (see the module docstring)."""
    on = True

    def __init__(self, tracer, owner=None, device=None):
        self.tracer = tracer
        self.id = next(_ids)
        self.owner = None if owner is None else weakref.ref(owner)
        self.device = None if device is None else str(device)
        self.ended = False
        self.stats = {}
        self.totals = {}          # name -> [count, total ns, self ns]
        self.steady = {}          # the same over steady frames
        self.steady_frames = 0
        self.stages = {}          # stage -> [count, ns] over steady replays
        self.replay = [0, 0]      # steady replays: [count, first-to-last ns]
        self.gaps = {}            # span name -> [count, ns] of steady replays' gaps
        self.gap = [0, 0]         # [steady replays with a gap, ns]
        self.lost_rows = 0
        self.clock = {"offset_ns": 0, "error_ns": 0, "resolution_ns": None, "drift_ns": None,
                      "rate_ppm": 0.0, "tracked_ns": 0}
        self._dev = None          # the device side (_Stamps), set by start_stamps

    # -- host spans ----------------------------------------------------
    def span(self, name, frame=None, **attrs):
        return Span(self, name, frame, attrs)

    def root(self):
        """The outermost open span of this thread, if it is this record's."""
        stack = _thread().stack
        return stack[0] if stack and stack[0].rec is self else NOSPAN

    def _close(self, s, t1):
        dur = t1 - s.t0
        own = dur - s.child
        parent = s.parent
        if parent is not None:
            parent.child += dur
        name = s.name
        entry = (s.sid, name, s.t0, t1, None if parent is None else parent.sid, s.frame,
                 self.id, s.th.tid, s.attrs)
        with self.tracer.lock:
            self.tracer.spans.append(entry)
            v = self.totals.get(name)
            if v is None:
                self.totals[name] = [1, dur, own]
            else:
                v[0] += 1
                v[1] += dur
                v[2] += own
            if s.root is not None:
                if s.root.desc is not None:
                    s.root.desc.append((name, dur, own))
            elif s.attrs.get("steady"):
                self.steady_frames += 1
                _add(self.steady, name, dur, own)
                for n, d, o in s.desc:
                    _add(self.steady, n, d, o)

    # -- device stamps -------------------------------------------------
    def start_stamps(self, device):
        """The device ring and the clock's offset (on the card: launches
        and waits)."""
        self._dev = _Stamps(self, device)

    def stamp(self, slot, advance=False):
        if self._dev is not None:
            self._dev.stamp(slot, advance)

    def row_done(self, kind, frame=None, steady=False, prefetched=None, launch_ns=None,
                 stages=None):
        """The row the last advancing stamp completed is of ``kind``;
        ``launch_ns``: the host clock just before its launch; ``stages``:
        (name, from slot, to slot) when not the kind's own (``row_stages``)."""
        if self._dev is not None:
            self._dev.row_done(kind, frame, steady, prefetched, launch_ns, stages)

    def observed(self, frame):
        """The host has just waited for frame ``frame``'s replay to end."""
        if self._dev is not None and self._dev.cuda:
            self._dev.seen[frame] = _now()

    def collect(self):
        """Read the ring's copies that the device has finished (no wait)."""
        if self._dev is not None:
            self._dev.collect()

    def flush(self):
        """Copy the ring now, wait for the copy and read it."""
        if self._dev is not None:
            self._dev.flush()

    def end(self):
        """The SLAM reached terminate(): read every row and keep the record."""
        if self._dev is not None:
            self._dev.flush()
            self._dev.measure_drift()
        self.ended = True

    # -- device rows on the host clock ---------------------------------
    def _row(self, kind, frame, steady, prefetched, t, gap, stages):
        """Enter one row (``t``: slot -> host ns) of ``stages``; returns its
        Row. ``gap``: (ns, midpoint on the host clock) since the replay
        before it, or None."""
        ns = {}
        for name, a, b in stages:
            ns[name] = ns.get(name, 0) + t[b] - t[a]
        row = Row(self.id, kind, frame, steady, prefetched, t[0], t[5], ns)
        if kind == "replay" and steady:
            for name, v in ns.items():
                if name != "upload":
                    _add2(self.stages, name, v)
            self.replay[0] += 1
            self.replay[1] += t[5] - t[0]
            if gap is not None:
                _add2(self.gaps, self._span_at(gap[1]), gap[0])
                self.gap[0] += 1
                self.gap[1] += gap[0]
        return row

    def _span_at(self, t):
        """The name of the innermost span of this record that ran at host
        time t (closed, or open on this thread), or "outside"."""
        best, best_len = "outside", None
        for s in reversed(_thread().stack):       # the deepest open span first
            if s.rec is self and s.t0 <= t:
                best, best_len = s.name, _now() - s.t0
                break
        with self.tracer.lock:
            for e in reversed(self.tracer.spans):
                if e[3] < t:
                    break
                if e[6] == self.id and e[2] <= t and (best_len is None or e[3] - e[2] < best_len):
                    best, best_len = e[1], e[3] - e[2]
        return best


def _add(d, name, dur, own):
    v = d.get(name)
    if v is None:
        d[name] = [1, dur, own]
    else:
        v[0] += 1
        v[1] += dur
        v[2] += own


def _add2(d, name, ns):
    v = d.get(name)
    if v is None:
        d[name] = [1, ns]
    else:
        v[0] += 1
        v[1] += ns


class _Stamps:
    """The device side of one record: the ring, its cursor, the rows
    launched and not yet read, the copies in flight."""

    def __init__(self, rec, device):
        import torch
        self.rec = rec
        self.cuda = device.type == "cuda"
        self.issued = 0            # rows the stream completes (advancing stamps run)
        self.read = 0              # rows read
        self.metas = deque()       # (kind, frame, steady, prefetched, launch, stages) per unread row
        self.prev = None           # (kind, device ns of its last stamp) of the last row read
        self.offset = 0            # device ns - host ns at dev0, as tracked
        self.rate = 0.0            # the offset's change per device ns
        self.dev0 = 0
        self.seen = {}             # frame -> host ns when a wait on its replay returned
        if not self.cuda:
            self.ring = np.zeros((RING_DEVICE, SLOTS), np.int64)
            self.cursor = 0
            rec.clock["resolution_ns"] = max(1, round(
                time.get_clock_info("perf_counter").resolution * 1e9))
            return
        from ..ops.stamp import Stamper, ticks
        self.torch = torch
        self.ring = torch.zeros((RING_DEVICE, SLOTS), dtype=torch.int64, device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self.stamper = Stamper(self.ring, self.cursor)
        self.copies = deque()      # (event, pinned buffer, rows issued when copied)
        self.spare = []            # (event, pinned buffer) pairs free for a copy
        self.copied = 0            # rows issued at the last copy
        self.clock0 = self._offset()
        self.offset, _, self.dev0 = self.clock0
        self.rate = rec.tracer.rates.get(rec.device, 0.0)
        rec.clock.update(offset_ns=self.clock0[0], error_ns=self.clock0[1],
                         rate_ppm=self.rate * 1e6)
        t = ticks(64, device).numpy()
        t = t[t > 0]
        rec.clock["resolution_ns"] = int(t.min()) if len(t) else None

    def _offset(self):
        """(offset, error bound, device ns) of the device timer from the
        host clock: the tightest of CLOCK_TRIALS stamps each launched and
        waited for."""
        from ..ops.stamp import Stamper
        torch = self.torch
        buf = torch.zeros((CLOCK_TRIALS + 1, 2), dtype=torch.int64, device=self.ring.device)
        cur = torch.zeros(1, dtype=torch.int64, device=self.ring.device)
        st = Stamper(buf, cur)
        stream = torch.cuda.current_stream(self.ring.device)
        st(0, True)                # first launch: the library's load
        stream.synchronize()
        host = []
        for _ in range(CLOCK_TRIALS):
            a = _now()
            st(0, True)
            stream.synchronize()
            host.append((a, _now()))
        dev = buf[1:, 0].cpu().numpy()
        i = min(range(CLOCK_TRIALS), key=lambda k: host[k][1] - host[k][0])
        a, b = host[i]
        return int(dev[i]) - (a + b) // 2, (b - a + 1) // 2, int(dev[i])

    def measure_drift(self):
        if self.cuda:
            offset, _, dev = self._offset()
            drift = offset - self.clock0[0]
            self.rec.clock["drift_ns"] = drift
            if dev - self.dev0 > 10e9:
                self.rec.tracer.rates[self.rec.device] = drift / (dev - self.dev0)

    def _offset_at(self, dev):
        return self.offset + int(self.rate * (dev - self.dev0))

    def stamp(self, slot, advance):
        if not self.cuda:
            row = self.ring[self.cursor % RING_DEVICE]
            row[slot] = _now()
            if advance:
                row[SLOTS - 1] = self.cursor
                self.cursor += 1
            return
        self.stamper(slot, advance)

    def row_done(self, kind, frame, steady, prefetched, launch_ns, stages):
        if not self.cuda:
            # read at once: the row the last advancing stamp completed
            self.read = self.issued = self.cursor - 1
        self.issued += 1
        self.metas.append((kind, frame, steady, prefetched, launch_ns,
                           stages or KINDS[kind][1]))
        if not self.cuda:
            self._read(self.ring, self.issued)
        elif self.issued - self.copied >= DRAIN_EVERY:
            self._copy()

    def _copy(self):
        torch = self.torch
        if self.spare:
            ev, buf = self.spare.pop()
        else:
            ev = torch.cuda.Event()
            buf = torch.empty((RING_DEVICE, SLOTS), dtype=torch.int64, pin_memory=True)
        buf.copy_(self.ring, non_blocking=True)
        ev.record()
        self.copies.append((ev, buf, self.issued))
        self.copied = self.issued

    def collect(self):
        if not self.cuda:
            return
        while self.copies and self.copies[0][0].query():
            ev, buf, upto = self.copies.popleft()
            self._read(buf.numpy(), upto)
            self.spare.append((ev, buf))

    def flush(self):
        if not self.cuda:
            return
        if self.issued > self.copied:
            self._copy()
        if self.copies:
            self.copies[-1][0].synchronize()
        self.collect()

    def _read(self, ring, upto):
        """Rows [read, upto) from a copy of the ring."""
        rec, tracer = self.rec, self.rec.tracer
        if upto - self.read > RING_DEVICE:
            lost = upto - self.read - RING_DEVICE
            rec.lost_rows += lost
            for _ in range(lost):
                self.metas.popleft()
            self.read += lost
            self.prev = None
        rows = []
        while self.read < upto:
            kind, frame, steady, prefetched, launch, stages = self.metas.popleft()
            r = ring[self.read % RING_DEVICE]
            if int(r[SLOTS - 1]) != self.read:
                rec.lost_rows += 1
                self.read += 1
                self.prev = None
                continue
            if launch is not None:
                self._track(int(r[0]), int(r[5]), launch, self.seen.pop(frame, None))
            offset = self._offset_at(int(r[0]))
            slots = set(KINDS[kind][0]).union(*(st[1:] for st in stages))
            t = {s: int(r[s]) - offset for s in slots}
            gap = None
            if kind == "replay" and self.prev is not None and self.prev[0] == "replay":
                g = int(r[0]) - self.prev[1]           # on the device's clock
                gap = (g, t[0] - g // 2)
            rows.append(rec._row(kind, frame, steady, prefetched, t, gap, stages))
            self.prev = (kind, int(r[5]))
            self.read += 1
        with tracer.lock:
            tracer.rows.extend(rows)
        if len(self.seen) > 2 * RING_DEVICE:     # waits on rows already read
            for f in sorted(self.seen)[:-RING_DEVICE]:
                del self.seen[f]

    def _track(self, first, last, launch, waited):
        """Keep the offset inside the band a replay's stamps allow: its
        first stamp after its launch, its last before the host's return
        from the wait on it."""
        o = self._offset_at(first)
        if first - o < launch:
            self.offset += first - launch - o
        o = self._offset_at(last)
        if waited is not None and last - o > waited:
            self.offset += last - waited - o
        self.rec.clock["tracked_ns"] = self.offset - self.clock0[0]


class _Off:
    """The record of a SLAM that traces nothing."""
    __slots__ = ()
    on = False
    id = None

    def span(self, name, frame=None, **attrs):
        return NOSPAN

    def root(self):
        return NOSPAN

    def start_stamps(self, device):
        pass

    def stamp(self, slot, advance=False):
        pass

    def row_done(self, kind, frame=None, steady=False, prefetched=None, launch_ns=None,
                 stages=None):
        pass

    def observed(self, frame):
        pass

    def collect(self):
        pass

    def flush(self):
        pass

    def end(self):
        pass


OFF = _Off()


class Tracer:
    """The process's records, raw spans and raw device rows."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans = deque(maxlen=RING_SPANS)
        self.rows = deque(maxlen=RING_ROWS)
        self.rates = {}           # device -> the last measured drift of its timer, per ns
        self._records = []
        self.process = Record(self)

    def new_record(self, owner, device):
        rec = Record(self, owner, device)
        with self.lock:
            keep = [r for r in self._records if r.ended or r.owner() is not None]
            ended = [r for r in keep if r.ended]
            drop = set(map(id, ended[:max(0, len(ended) - KEEP_ENDED)]))
            self._records = [r for r in keep if id(r) not in drop] + [rec]
        return rec

    def records(self):
        """Records of live SLAMs and kept ended ones, in construction order."""
        with self.lock:
            return [r for r in self._records if r.ended or r.owner() is not None]

    def ended(self, n=None):
        """The newest ``n`` (all when None) records whose SLAM reached
        terminate(), oldest first."""
        done = [r for r in self.records() if r.ended]
        return done if n is None else done[max(0, len(done) - n):] if n else []


TRACER = Tracer()


def new_record(owner, device):
    return TRACER.new_record(owner, device)


def ended(n=None):
    return TRACER.ended(n)


def span(name, **attrs):
    """A span of the process's record (work of no SLAM)."""
    return TRACER.process.span(name, **attrs)


def raw_spans(rec, name=None):
    """The raw spans of ``rec`` still in the ring (of ``name`` only when given)."""
    with TRACER.lock:
        return [e for e in TRACER.spans if e[6] == rec.id and (name is None or e[1] == name)]


def raw_rows(rec, kind=None):
    """The device rows of ``rec`` still in the ring (of ``kind`` only when given)."""
    with TRACER.lock:
        return [r for r in TRACER.rows if r.record == rec.id and (kind is None or r.kind == kind)]


def summary(rec):
    """Lines for an operator: each span's count, mean and median (ms) and
    mean self time, the steady frames' spans per frame, the counters, the
    steady replays' device stages and the device gaps by host span."""
    out = []
    for name, (count, total, own) in rec.totals.items():
        d = [e[3] - e[2] for e in raw_spans(rec, name)]
        med = f"{statistics.median(d) / 1e6:.3f}" if d else "-"
        out.append(f"span {name}: {count} calls, mean {total / count / 1e6:.3f} ms, median "
                   f"{med} ms, self {own / count / 1e6:.3f} ms")
    if rec.steady_frames:
        per = {k: v[1] / rec.steady_frames / 1e6 for k, v in rec.steady.items()}
        out.append(f"steady frames: {rec.steady_frames}; ms per frame: "
                   + ", ".join(f"{k} {v:.3f}" for k, v in per.items()))
    if rec.stats:
        out.append("counters: " + ", ".join(f"{k} {v}" for k, v in rec.stats.items()))
    if rec.replay[0]:
        out.append(f"device stages (ms per steady replay, {rec.replay[0]} replays): "
                   + ", ".join(f"{k} {v[1] / v[0] / 1e6:.3f}" for k, v in rec.stages.items())
                   + f"; replay {rec.replay[1] / rec.replay[0] / 1e6:.3f}")
    if rec.gap[0]:
        out.append(f"device gaps (ms per steady frame, {rec.gap[0]} frames): "
                   + ", ".join(f"{k} {v[1] / rec.gap[0] / 1e6:.3f}" for k, v in
                               sorted(rec.gaps.items(), key=lambda kv: -kv[1][1])))
    c = rec.clock
    if c["resolution_ns"] is not None:
        out.append(f"clock: offset error {c['error_ns']} ns, resolution {c['resolution_ns']} "
                   f"ns, drift {c['drift_ns']} ns (tracked {c['tracked_ns']} ns); rows lost "
                   f"{rec.lost_rows}")
    return out
