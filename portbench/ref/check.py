"""The comparison that decides ``correct``.

A sampled steady-state step of the program is held to the reference
(``slam.step``) run from the same state and inputs: the program's state
just before the step and its host inputs go in, and what the step wrote
is compared, stage by stage, each number the gap's 2-norm over the
reference's (``name``) or the largest gap over the largest reference value
(``name.max``):

- ``fmap``, ``ctx``, ``gmap``: the new frame's matching features, its
  context rows (DINOv2 through K2, or VONet's context encoder) and its
  gathered patch features (the networks and the patch gathers);
- ``net``, ``delta``, ``weight``: the update operator's hidden state, its
  flow step (target - centre) and its confidence weight over the real
  edges, from the reference's own update (the correlation feeds all three);
  ``delta`` over the edges whose reference centre lies within
  ``CENTRE_MAX`` pixels: farther out (a patch reprojected millions of
  pixels away) the float32 centre itself rounds by a quarter or half pixel
  on either side, more than the flow step it carries;
- ``ba_pose``, ``ba_depth``: the BA's poses (from its first frame on) and
  the window's inverse depths against the reference's BA run on the
  program's own target and weight, over the change that BA made: the BA
  follows the program's update, so it is checked as a stage of its own.

The host's index rows of each step (``index_numbers``) are held to the
reference's own build from the step's edges: ``aux_rows`` (neighbours,
segments, the group permutation, the mask), ``slot_rows`` (the physical
slots) and ``net_src`` (each edge's hidden state from the step before),
exactly.

A number that is not finite reads as ``BAD``. Each number is the largest
over the sampled steps. The control puts the reference with float8
networks and TF32 (and the BA in TF32) in the program's place.
"""
from __future__ import annotations

import numpy as np
import torch

from .models import CDVNet, VONet
from .models.update import build_update_aux
from .slam.kernels import BLOCK_ROWS, SCALARS
from .slam.step import Settings, StepKey, ba_stage, precision, step, to_fp8_control
from .weights import meta_model, state_dict

BAD = 1e30
# centres (1/4 resolution) beyond this many pixels leave the delta gap:
# float32 resolves 1/2,000 of a pixel here, 0.25-0.5 px at 2-5 million
CENTRE_MAX = 4096.0


def _finite(v):
    v = float(v)
    return v if v == v and abs(v) < BAD else BAD


def gaps(name, a, b, scale):
    """{name: ||a - b|| / ||scale||, name + ".max": max|a - b| / max|scale|},
    BAD where not finite."""
    a, b, scale = a.double(), b.double(), scale.double()
    d = a - b
    return {name: _finite(d.norm() / scale.norm().clamp(min=1e-30)),
            name + ".max": _finite(d.abs().max() / scale.abs().max().clamp(min=1e-30))
            if d.numel() else 0.0}


def reference_model(network, seed, device, control=False):
    """The reference network in float32 on ``device`` with the weights of
    ``seed``; under ``control`` every linear and convolution runs through
    float8."""
    cls = VONet if network == "dpv" else CDVNet
    model = cls()
    model.load_state_dict(state_dict(meta_model(cls), seed, device))
    model = model.to(device=device, dtype=torch.float32).eval()
    if control:
        to_fp8_control(model)
    return model


def _on(t, device):
    """A float32 (floating) or same-type copy of t on device, never a view."""
    return t.to(device, torch.float32 if t.is_floating_point() else t.dtype, copy=True)


def numbers(post, ref_st, out, ba, M):
    """The numbers of one sampled step: ``post`` (the state after the step
    of the program, or of the control) against the reference's ``ref_st``
    and ``out``, and its poses and depths against ``ba`` (the reference's
    BA run on the same step's own target and weight)."""
    post = {k: v.to(ref_st[k].device) for k, v in post.items()}
    n, fs, ps, t0 = (int(out[k]) for k in ("n", "fs", "ps", "t0"))
    ring = slice(ps * M, (ps + 1) * M)
    mask = out["mask"]
    E_pad = mask.shape[0]
    tw_p, tw_r = post["tw_buf"][:E_pad][mask], ref_st["tw_buf"][:E_pad][mask]
    frames = slice(t0, n + 1)
    win = out["win"]
    live = win < (n + 1) * M
    ba_poses, ba_patches = ba
    d_ba = ba_patches[live][:, 2, 1, 1]
    got = {}
    for name, a, b in (("fmap", post["fmap1_"][fs], ref_st["fmap1_"][fs]),
                       ("ctx", post["imap_"][ring], ref_st["imap_"][ring]),
                       ("gmap", post["gmap_"][ring], ref_st["gmap_"][ring]),
                       ("net", post["net"][:E_pad][mask], ref_st["net"][:E_pad][mask]),
                       ("weight", tw_p[:, 2:], tw_r[:, 2:])):
        got.update(gaps(name, a, b, b))
    centre = out["center"][mask]
    near = centre.abs().amax(1) <= CENTRE_MAX
    got.update(gaps("delta", tw_p[near, :2], tw_r[near, :2], tw_r[near, :2] - centre[near]))
    got.update(gaps("ba_pose", post["poses_"][frames], ba_poses[frames],
                    ba_poses[frames] - out["poses_before"][frames]))
    got.update(gaps("ba_depth", post["patches_"][win][live][:, 2, 1, 1], d_ba,
                    d_ba - out["patches_win_before"][live][:, 2, 1, 1]))
    return got


@torch.no_grad()
def check(samples, network, settings: Settings, seed, device, control=False):
    """The largest of each number over ``samples`` (each a dict: ``key`` the
    step's (E_pad, KWIN, iterations, shift_span), ``image``, ``ints``,
    ``floats``, ``pre`` and ``post`` state dicts and the program's ``mm``).
    ``control``: the numbers of the control in the program's place instead:
    the reference with float8 networks and TF32 for the networks and the
    update, and the BA in TF32 on the program's target and weight."""
    worst = {}
    with precision(False):
        model = reference_model(network, seed, device, control=control)
        ref = reference_model(network, seed, device) if control else model
        for s in samples:
            key = StepKey(*s["key"])
            args = (torch.as_tensor(s["image"]).to(device), torch.as_tensor(s["ints"]).to(device),
                    torch.as_tensor(s["floats"]).to(device))
            ref_st = {k: _on(v, device) for k, v in s["pre"].items()}
            out = step(ref, ref_st, *args, key, settings)
            tw = _on(s["post"]["tw_buf"][:key.E_pad], device)
            ba = ba_stage(out, tw, key, settings)
            post = s["post"]
            if control:
                post = {k: _on(v, device) for k, v in s["pre"].items()}
                with precision(True):
                    step(model, post, *args, key, settings)
                    poses, patches = ba_stage(out, tw, key, settings)
                post["poses_"] = poses
                post["patches_"][out["win"]] = patches
            for name, v in numbers(post, ref_st, out, ba, settings.M).items():
                worst[name] = max(worst.get(name, 0.0), v)
            del ref_st, out, post
    return worst


def _split(ints):
    """(rows (len(BLOCK_ROWS), E_pad), scalars dict, E) of an int block; E,
    the real edges, are those before the trailing pad (padded edges read
    row 0: ii, jj and kk_local 0, where a real edge's newest frame is
    never row 0)."""
    n_rows = len(BLOCK_ROWS)
    E_pad = (len(ints) - len(SCALARS)) // n_rows
    rows = np.asarray(ints[: n_rows * E_pad], np.int64).reshape(n_rows, E_pad)
    tail = dict(zip(SCALARS, np.asarray(ints[n_rows * E_pad:], np.int64).tolist()))
    r = dict(zip(BLOCK_ROWS, rows))
    zero = (r["ii"] == 0) & (r["jj"] == 0) & (r["kk_local"] == 0)
    E = E_pad - int(np.argmin(zero[::-1])) if not zero.all() else 0
    return r, tail, E


def _aux_rows(r, tail, E, E_pad, KWIN, s: Settings):
    """Entries of the update's neighbour, segment, permutation and mask rows
    that differ from the reference's own build from the edges (ii, jj,
    kk_local), and real edges whose rows disagree with each other."""
    ii, jj, kl = r["ii"][:E], r["jj"][:E], r["kk_local"][:E]
    bad = int(((kl < 0) | (kl >= KWIN) | ((kl + tail["k0"]) // s.M != ii)).sum())
    cdv = s.network == "cdv"
    try:
        aux = build_update_aux(ii, jj, kl, 0, KWIN, M=s.M if cdv else None, n_gseg=E_pad,
                               E_pad=E_pad)
    except ValueError:                       # not whole groups of M
        return bad + 7 * E_pad
    perm = np.zeros(E_pad, np.int64)
    if cdv:
        perm[: aux.perm.size] = aux.perm.reshape(-1)
    want = {"ix": aux.ix, "jx": aux.jx, "kseg": aux.kseg, "gseg": aux.gseg, "perm": perm,
            "inv_perm": aux.inv_perm if cdv else np.zeros(E_pad), "mask": aux.mask}
    return bad + sum(int((r[k] != np.asarray(v, np.int64)).sum()) for k, v in want.items())


def _slot_rows(r, tail, E, s: Settings):
    """Real edges whose physical slots break the slot tables' rules: one
    patch slot per patch frame and one frame slot per target frame, each
    slot for one frame, the patch's place kept, the new frame's slots as
    the step's scalars name them."""
    ii, jj, kl = r["ii"][:E], r["jj"][:E], r["kk_local"][:E]
    pslot, m, fslot = r["ctx"][:E] // s.M, r["ctx"][:E] % s.M, r["jjm"][:E]
    bad = int((m != kl % s.M).sum())
    for frame, slot in ((ii, pslot), (jj, fslot)):
        pairs = len(np.unique(frame * (1 << 32) + slot))
        bad += (pairs - len(np.unique(frame))) + (pairs - len(np.unique(slot)))
    n = tail["n"]
    return bad + int((fslot[jj == n] != tail["fs"]).sum() + (pslot[ii == n] != tail["ps"]).sum())


def _net_src(r, tail, E, prev):
    """Edges whose hidden-state source breaks the rules: a new edge (from
    or to the new frame n) and a pad start from none (-1); every other edge
    from a row of the step before that holds the same edge (the same patch
    slot and frame slot: physical slots do not move when rows are
    renumbered), each row once."""
    if prev is None:
        return E
    src, n = r["net_src"], tail["n"]
    pr, _, E_prev = _split(prev)
    new = (r["ii"][:E] == n) | (r["jj"][:E] == n)
    s = src[:E]
    bad = int((s[new] != -1).sum() + (src[E:] != -1).sum())
    old = s[~new]
    ok = (old >= 0) & (old < E_prev)
    bad += int((~ok).sum())
    e_old = np.nonzero(~new)[0][ok]
    o = old[ok]
    bad += int(((pr["ctx"][o] != r["ctx"][e_old]) | (pr["jjm"][o] != r["jjm"][e_old])).sum())
    return bad + len(o) - len(np.unique(o))


def index_numbers(samples, s: Settings):
    """The host's index rows of each sampled step (what the runtime's edge
    bookkeeping and its cache of shift-invariant rows made) against the
    reference's own: ``aux_rows``, ``slot_rows`` and ``net_src``, counts of
    the entries that break them, summed over the steps (exact: limit 0)."""
    got = {"aux_rows": 0, "slot_rows": 0, "net_src": 0}
    for smp in samples:
        E_pad, KWIN = smp["key"][0], smp["key"][1]
        r, tail, E = _split(smp["ints"])
        got["aux_rows"] += _aux_rows(r, tail, E, E_pad, KWIN, s)
        got["slot_rows"] += _slot_rows(r, tail, E, s)
        got["net_src"] += _net_src(r, tail, E, smp["prev_ints"])
    return got
