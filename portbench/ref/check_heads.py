"""The comparison that decides ``correct`` in a CDVO++ cell.

A sampled steady-state step of the program is held to the reference
(``slam.step_heads``) run from the same state and inputs, as ``check.py``
holds a CDVO step, and fed the program's discrete outputs past its own
(``step_heads.Staged``: the chosen cells, the seg classes, the score row).
The numbers are ``check.numbers``' (``fmap``, ``ctx``, ``gmap``, ``net``,
``weight``, ``delta``; the update's weights take the program's seg and
score rows; ``ba_pose`` and ``ba_depth`` after the reference's BA and then
its scale adjustment, on the program's own target and weight, started
from the program's initial patch row and scale anchor of the new frame),
and:

- ``seg``: how far the reference seg head's logits at the program's cells
  rank the program's class below their best, over the logits' spread
  (the largest over the new frame's patches; 0 where they agree). A near
  tie flips between float32 and bfloat16 tokens; a class far down the
  reference's ranking does not;
- ``score``: how far the reference's dynamic-class call at each chosen
  cell contradicts the program's score there: the reference's dynamic
  margin (``step_heads.features_heads``' ``dyn_margin``) where the program
  scored the cell 1 (static), its negative where 0, none below 0; a score
  not 0 or 1, or not 0 on a border cell, reads ``check.BAD``;
- ``depth``, ``depth.max``: the new frame's initial inverse depths (the
  program's patch row, ``row``) against the reference depth head's at the
  program's cells; ``depth.scale``: its scale anchor (``scale_``, their
  centres' mean), relative;
- ``select``: the share of the program's chosen cells that the
  reference's own selection (from its own float32 tokens, with the same
  uniforms) does not choose.

The configuration's ``limits`` name the numbers held; the others are
readings (PERF.md says why).

Each number is the largest over the sampled steps; one that is not finite
reads as ``check.BAD``. The control puts the reference with float8
networks and heads and TF32 (the BA in TF32 too) in the program's place:
it makes its own selection and its own initial depths, and the reference
is fed its outputs.
"""
from __future__ import annotations

import torch

from .check import BAD, _finite, _on, gaps, numbers, reference_model
from .models.heads import DepthHeadFlatten, SegHeadFlatten
from .slam.kernels import SCALARS
from .slam.step import Settings, StepKey, precision, to_fp8_control
from .slam.step_heads import ADE20K_INDEX_FILT, Heads, ba_scale_stage, staged_from, step


def reference_heads(head_sds, device, control=False) -> Heads:
    """The two heads in float32 on ``device`` from their state dicts (seg,
    depth); under ``control`` their linear layers run through float8."""
    mods = []
    for cls, sd in zip((SegHeadFlatten, DepthHeadFlatten), head_sds):
        head = cls()
        head.load_state_dict(sd)
        head = head.to(device=device, dtype=torch.float32).eval()
        if control:
            to_fp8_control(head)
        mods.append(head)
    return Heads(*mods, torch.tensor(ADE20K_INDEX_FILT, device=device))


def head_numbers(post, ref_st, out, staged, row, M):
    """``select``, ``seg``, ``score`` and ``depth`` of one step: ``post``
    (the program's state after it), ``staged`` (its outputs read from
    ``post``) and ``row`` (its initial patch row of the new frame) against
    the reference's state ``ref_st`` and ``out``."""
    f = out["feats"]
    n = int(out["n"])
    own = set(f["own_cells"].tolist())
    lg = f["seg_logits"].double()
    seg = (lg.amax(1) - lg.gather(1, staged.seg.long()[:, None])[:, 0]) / lg.std(1)
    y, x = staged.cells // f["wi"], staged.cells % f["wi"]
    border = (y == 0) | (y == f["hi"] - 1) | (x == 0) | (x == f["wi"] - 1)
    sc = staged.score.double()
    margin = f["dyn_margin"][staged.cells].double()
    bad = ((sc != 0) & (sc != 1)) | (border & (sc != 0))
    score = BAD if bool(bad.any()) else float(
        torch.where(border, 0.0, torch.where(sc == 1, margin, -margin)).clamp(min=0).max())
    a, b = post["scale_"][n].double(), ref_st["scale_"][n].double()
    return {"select": sum(int(c) not in own for c in staged.cells) / M,
            "seg": _finite(seg.max()), "score": score,
            "depth.scale": _finite((a - b).abs() / b.abs().clamp(min=1e-30)),
            **gaps("depth", row[:, 2], f["patch_row"][:, 2], f["patch_row"][:, 2])}


@torch.no_grad()
def check(samples, settings: Settings, seed, head_sds, window, device, control=False, rows=None):
    """The largest of each number over ``samples`` (as ``check.check``'s);
    ``head_sds`` the (seg, depth) heads' state dicts, ``window`` the scale
    adjustment's (OPTIMIZATION_WINDOW); ``rows``: each
    sample's initial patch row of the new frame as the program made it
    (its own step, run eagerly again). ``control``: the numbers of the
    control in the program's place instead (its own rows)."""
    worst = {}
    M = settings.M
    with precision(False):
        ref = reference_model("cdv", seed, device)
        heads = reference_heads(head_sds, device)
        if control:
            model = reference_model("cdv", seed, device, control=True)
            heads_c = reference_heads(head_sds, device, control=True)
        for i, s in enumerate(samples):
            key = StepKey(*s["key"])
            args = (torch.as_tensor(s["image"]).to(device), torch.as_tensor(s["ints"]).to(device),
                    torch.as_tensor(s["floats"]).to(device))
            tw = _on(s["post"]["tw_buf"][:key.E_pad], device)
            post = s["post"]
            if control:
                post = {k: _on(v, device) for k, v in s["pre"].items()}
                with precision(True):
                    out_c = step(model, heads_c, post, *args, key, settings)
                    poses, patches = ba_scale_stage(out_c, tw, key, settings, post, window)
                post["poses_"] = poses
                post["patches_"][out_c["win"]] = patches
                row = out_c["feats"]["patch_row"]
                del out_c
            else:
                row = _on(rows[i], device)
            post = {k: _on(v, device) for k, v in post.items()}
            ref_st = {k: _on(v, device) for k, v in s["pre"].items()}
            n = int(args[1][len(args[1]) - len(SCALARS) + SCALARS.index("n")])
            staged = staged_from(post, n, M, -(-settings.wd // 14), settings.upperleft)
            out = step(ref, heads, ref_st, *args, key, settings, staged=staged)
            ba = ba_scale_stage(out, tw, key, settings, ref_st, window, row, post["scale_"][n])
            got = numbers(post, ref_st, out, ba, M)
            got.update(head_numbers(post, ref_st, out, staged, row, M))
            for name, v in got.items():
                worst[name] = max(worst.get(name, 0.0), v)
            del ref_st, out, post
    return worst
