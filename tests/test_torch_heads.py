"""The port's seg and depth heads and their hooks against the JAX package.

Inputs are drawn from a seed with numpy; weights are the flax modules'
seeded inits carried into the port by ``models.convert`` (the inverse of
the JAX package's ``.pth`` loaders), or a ``.pth`` written here under the
reference's names and read by both loaders. Tolerances:
- seg logits 1e-5 absolute with equal argmax classes and dynamic masks;
  linear depth head 1e-4 relative (a 256-bin dot with depths up to 80);
- DPT head 1e-4 of max |JAX| (float32 convolutions summed in another
  order through 13 layers); the resizes 1e-5 relative;
- SCORE selection: the same cells, coordinates and scores exactly on the
  same uniforms; seg_binary_score and dynamic_class_weight exactly;
- scale_adjustment 1e-6 absolute (means of float32 depths summed in
  another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdvslam_tpu.models import convert as jconvert
from cdvslam_tpu.models.dpt import DPTHead as JaxDPTHead
from cdvslam_tpu.models.heads import DepthHeadFlatten as JaxDepthHead
from cdvslam_tpu.models.heads import SegHeadFlatten as JaxSegHead
from cdvslam_tpu.models.patchifier import seg_binary_score as jax_seg_binary_score
from cdvslam_tpu.models.patchifier import select_score as jax_select_score
from cdvslam_tpu.ops.patchify import patchify as jax_patchify
from cdvslam_tpu.slam import kernels as jkernels
from cdvslam_tpu_torch.lie import se3_exp
from cdvslam_tpu_torch.models.convert import depth_head_state, dpt_head_state, seg_head_state
from cdvslam_tpu_torch.models.datamaps import ADE20K_INDEX_FILT
from cdvslam_tpu_torch.models.dpt import DPTHead, resize
from cdvslam_tpu_torch.models.heads import DepthHeadFlatten, SegHeadFlatten
from cdvslam_tpu_torch.models.patchifier import seg_binary_score, select_score
from cdvslam_tpu_torch.ops.patchify import patchify
from cdvslam_tpu_torch.slam import kernels
from cdvslam_tpu_torch.slam.runtime import _load_head

torch.set_num_threads(2)
SCALE_F2I = 4.0 / 14.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _seg_heads(seed=0):
    """A flax SegHeadFlatten init with non-trivial BN statistics, and the
    port's head carrying the same weights."""
    jhead = JaxSegHead()
    v = _np(jhead.init(jax.random.PRNGKey(seed), jnp.zeros((1, 384))))
    rng = np.random.RandomState(seed)
    v["params"]["bn"] = {"scale": rng.uniform(0.5, 1.5, 384).astype(np.float32),
                         "bias": rng.randn(384).astype(np.float32) * 0.1}
    v["batch_stats"]["bn"] = {"mean": rng.randn(384).astype(np.float32) * 0.2,
                              "var": rng.uniform(0.5, 2.0, 384).astype(np.float32)}
    head = SegHeadFlatten()
    head.load_state_dict(seg_head_state(v))
    return jhead, v, head


def test_seg_head_and_filt_mask_match_jax():
    jhead, v, head = _seg_heads()
    x = np.random.RandomState(1).randn(400, 384).astype(np.float32)
    want = np.asarray(jhead.apply(v, jnp.asarray(x)))
    got = head(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    cls = np.asarray(jhead.apply(v, jnp.asarray(x), method=JaxSegHead.seg_class))
    np.testing.assert_array_equal(head.seg_class(torch.from_numpy(x)).numpy(), cls)
    filt = np.asarray(ADE20K_INDEX_FILT)
    jmask = np.asarray(jhead.apply(v, jnp.asarray(x), jnp.asarray(filt),
                                   method=JaxSegHead.filt_mask))
    mask = head.filt_mask(torch.from_numpy(x), torch.from_numpy(filt)).numpy()
    np.testing.assert_array_equal(mask, jmask)
    assert 0 < mask.mean() < 1                      # both outcomes are exercised


def test_depth_head_matches_jax():
    jhead = JaxDepthHead()
    v = _np(jhead.init(jax.random.PRNGKey(12), jnp.zeros((1, 768))))
    head = DepthHeadFlatten()
    head.load_state_dict(depth_head_state(v))
    x = np.random.RandomState(2).randn(300, 768).astype(np.float32)
    want = np.asarray(jhead.apply(v, jnp.asarray(x)))
    got = head(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (300, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def _taps(rng, h, w):
    return [(rng.randn(1, h, w, 384).astype(np.float32), rng.randn(1, 384).astype(np.float32))
            for _ in range(4)]


@pytest.mark.parametrize("h,w", [(5, 7), (35, 54)])
def test_dpt_head_matches_jax(h, w):
    """Both sizes: the 64 x 96 and the 480 x 752 token grids. The
    transposed convolutions go through the JAX loader's spatial flip."""
    rng = np.random.RandomState(h)
    taps = _taps(rng, h, w)
    jhead = JaxDPTHead()
    jtaps = [(jnp.asarray(t), jnp.asarray(c)) for t, c in taps]
    v = _np(jhead.init(jax.random.PRNGKey(12), jtaps))
    # flax's zero biases would hide a bias mapped to the wrong layer
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.01 * rng.randn(*a.shape).astype(np.float32)
        if p[-1].key == "bias" else a, v)
    head = DPTHead()
    head.load_state_dict(dpt_head_state(v))
    want = np.asarray(jhead.apply(v, jtaps))[..., 0]
    with torch.no_grad():
        got = head([(torch.from_numpy(t), torch.from_numpy(c)) for t, c in taps])[:, 0].numpy()
    assert got.shape == want.shape == (1, 32 * (-(-h // 2)), 32 * (-(-w // 2)))
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("src", [(576, 864), (35, 54), (96, 128)])
def test_depth_resize_matches_jax_image_resize(src):
    """1/depth to the (hf, wf) grid: the DPT's 576 x 864 and the linear
    head's 35 x 54 maps at 480 x 752, and the DPT's 96 x 128 at 64 x 96;
    jax.image.resize antialiases the shrinking ones."""
    dst = (120, 188) if src[0] != 96 else (16, 24)
    x = np.random.RandomState(3).uniform(0.01, 2.0, (1,) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1,) + dst, method="bilinear"))
    got = resize(torch.from_numpy(x)[None], dst)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    plain = torch.nn.functional.interpolate(torch.from_numpy(x)[None], dst, mode="bilinear")
    assert src[0] < dst[0] or np.abs(plain[0].numpy() - want).max() > 1e-2


def _score_case(hi, wi, seed):
    """A dynamic mask (30% of the cells) and the uniforms the JAX SLAM draws
    from key ``seed`` (under jax.jit, as its frame program does)."""
    dyn = np.random.RandomState(seed).rand(hi * wi) < 0.3
    u = jax.jit(lambda key: jax.random.uniform(key, (1, hi * wi), minval=1e-12, maxval=1.0))(
        jax.random.PRNGKey(seed))
    return dyn, np.asarray(u)


@pytest.mark.parametrize("hi,wi,M", [(5, 7, 8), (35, 54, 96)])
@pytest.mark.parametrize("upperleft", [True, False])
def test_select_score_matches_jax(hi, wi, M, upperleft):
    dyn, u = _score_case(hi, wi, hi)
    jmap = jax_seg_binary_score(jnp.asarray(dyn), 1, hi, wi)
    smap = seg_binary_score(torch.from_numpy(dyn), 1, hi, wi)
    np.testing.assert_array_equal(smap.numpy(), np.asarray(jmap))
    assert smap.sum() < (hi - 2) * (wi - 2)          # some interior cells are dynamic
    jc, js = jax.jit(lambda key, smap: jax_select_score(key, smap, M, SCALE_F2I, upperleft))(
        jax.random.PRNGKey(hi), jmap)
    tc, ts = select_score(torch.tensor(u), smap, M, SCALE_F2I, upperleft)
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc)[0])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts.numpy() == 1).sum() == min(M, int(smap.sum()))   # static cells first


def test_score_upperleft_gather_lands_on_jax_tokens_and_misses_cells():
    """The upper-left context gather of SCORE's coordinates reads the same
    token in both, and for most cells not the selected one: the jitted
    JAX coordinate cell / (4/14) is cell * 3.4999998, and
    floor((4/14) x) falls one short (ROADMAP Queue 3)."""
    hi, wi = 35, 54
    dyn, u = _score_case(hi, wi, 1)
    smap = seg_binary_score(torch.from_numpy(dyn), 1, hi, wi)
    tmap = np.arange(hi * wi, dtype=np.float32).reshape(1, 1, hi, wi)

    @jax.jit
    def jax_tokens(key, smap):
        coords, _ = jax_select_score(key, smap, 96, SCALE_F2I, True)
        return jax_patchify(jnp.asarray(tmap), SCALE_F2I * coords, 0, mode="upperleft")

    want = np.asarray(jax_tokens(jax.random.PRNGKey(1), jnp.asarray(smap.numpy())))
    coords, _ = select_score(torch.tensor(u), smap, 96, SCALE_F2I, True)
    got = patchify(torch.from_numpy(tmap), SCALE_F2I * coords, 0, mode="upperleft")
    got = got[0, :, 0, 0, 0].numpy()
    np.testing.assert_array_equal(got, want[0, :, 0, 0, 0])
    x, y = (coords[0] / 3.4999998).round().long().unbind(-1)
    cells = (y * wi + x).numpy()
    assert ((smap.reshape(-1).numpy()[cells]) == 1).all()
    assert (got != cells).mean() > 0.5


def test_dynamic_class_weight_matches_jax():
    rng = np.random.RandomState(4)
    seg = rng.randint(0, 150, (32, 8)).astype(np.uint8)
    seg[3, :4] = ADE20K_INDEX_FILT[:4]
    kk = rng.randint(0, 32 * 8, 500)
    kk[:8] = np.arange(24, 32)
    filt = np.asarray(ADE20K_INDEX_FILT, np.uint8)
    want = np.asarray(jkernels.dynamic_class_weight(jnp.asarray(seg), jnp.asarray(filt),
                                                    jnp.asarray(kk, jnp.int32)))
    got = kernels.dynamic_class_weight(torch.from_numpy(seg), torch.tensor(ADE20K_INDEX_FILT),
                                       torch.from_numpy(kk)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == np.float32(1e-4)).any() and (got == 1).any()


@pytest.mark.parametrize("gate", ["open", "shut"])
def test_scale_adjustment_matches_jax(gate):
    rng = np.random.RandomState(5)
    N, M, P, t0, n = 32, 8, 3, 3, 13
    xi = rng.randn(N, 6) * 0.1
    xi[:, 3:] *= 0.3
    if gate == "shut":
        xi[n - 2, 3:] = xi[n - 1, 3:] + 0.001      # 0.0017 rad between n-2 and n-1
    poses = se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()
    patches = (rng.rand(N * M, 3, P, P) + 0.2).astype(np.float32)
    scale = (rng.rand(N) + 0.3).astype(np.float32)
    jp, jq = jkernels.scale_adjustment(jnp.asarray(poses), jnp.asarray(patches),
                                       jnp.asarray(scale), t0, n, 0.2, M=M, P=P)
    tp, tq, rate = kernels.scale_adjustment(torch.tensor(poses), torch.tensor(patches),
                                            torch.tensor(scale), t0, n, 0.2, M)
    assert (float(rate) == 1.0) == (gate == "shut")
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    moved = np.abs(np.asarray(jq) - patches).max()
    assert (moved > 1e-3) == (gate == "open")


def _dpt_reference_sd(rng):
    """A DPT state dict under the reference's names (the key list of
    tests/test_heads_integration.py), with ``decode_head.``."""
    C, ch, out_ch = 384, 256, [48, 96, 192, 384]
    sd = {}

    def T(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.05)

    d = "decode_head."
    for i in range(4):
        sd[f"{d}reassemble_blocks.readout_projects.{i}.0.weight"] = T(C, 2 * C)
        sd[f"{d}reassemble_blocks.readout_projects.{i}.0.bias"] = T(C)
        sd[f"{d}reassemble_blocks.projects.{i}.conv.weight"] = T(out_ch[i], C, 1, 1)
        sd[f"{d}reassemble_blocks.projects.{i}.conv.bias"] = T(out_ch[i])
        sd[f"{d}convs.{i}.conv.weight"] = T(ch, out_ch[i], 3, 3)
        sd[f"{d}fusion_blocks.{i}.project.conv.weight"] = T(ch, ch, 1, 1)
        sd[f"{d}fusion_blocks.{i}.project.conv.bias"] = T(ch)
        for u in ([1, 2] if i > 0 else [2]):
            for c in [1, 2]:
                sd[f"{d}fusion_blocks.{i}.res_conv_unit{u}.conv{c}.conv.weight"] = T(ch, ch, 3, 3)
    for k, (c, ks) in {0: (out_ch[0], 4), 1: (out_ch[1], 2), 3: (out_ch[3], 3)}.items():
        sd[f"{d}reassemble_blocks.resize_layers.{k}.weight"] = T(c, c, ks, ks)
        sd[f"{d}reassemble_blocks.resize_layers.{k}.bias"] = T(c)
    sd[f"{d}project.conv.weight"] = T(ch, ch, 3, 3)
    sd[f"{d}project.conv.bias"] = T(ch)
    sd[f"{d}conv_depth.head.0.weight"] = T(ch // 2, ch, 3, 3)
    sd[f"{d}conv_depth.head.0.bias"] = T(ch // 2)
    sd[f"{d}conv_depth.head.2.weight"] = T(32, ch // 2, 3, 3)
    sd[f"{d}conv_depth.head.2.bias"] = T(32)
    sd[f"{d}conv_depth.head.4.weight"] = T(1, 32, 1, 1)
    sd[f"{d}conv_depth.head.4.bias"] = T(1)
    return sd


def test_reference_checkpoints_load_in_both(tmp_path):
    """.pth files under the reference's names: the seg and linear depth
    heads as plain state dicts, the DPT under {"state_dict": ...} with
    ``decode_head.`` keys. The JAX loaders and the port's loader give
    heads that agree."""
    rng = np.random.RandomState(7)
    seg_sd = {"bn.weight": torch.rand(384) + 0.5, "bn.bias": torch.randn(384) * 0.1,
              "bn.running_mean": torch.randn(384) * 0.2, "bn.running_var": torch.rand(384) + 0.5,
              "bn.num_batches_tracked": torch.tensor(100),
              "linear.weight": torch.randn(150, 384) * 0.05, "linear.bias": torch.randn(150) * 0.05}
    depth_sd = {"linear.weight": torch.randn(256, 768) * 0.05, "linear.bias": torch.randn(256) * 0.05}
    dpt_sd = _dpt_reference_sd(rng)
    paths = {name: tmp_path / f"{name}.pth" for name in ("seg", "depth", "dpt")}
    torch.save(seg_sd, paths["seg"])
    torch.save(depth_sd, paths["depth"])
    torch.save({"state_dict": dpt_sd}, paths["dpt"])

    seg, depth, dpt = SegHeadFlatten(), DepthHeadFlatten(), DPTHead()
    for head, name in ((seg, "seg"), (depth, "depth"), (dpt, "dpt")):
        _load_head(head, str(paths[name]))
    assert set(dpt.state_dict()) == {k.removeprefix("decode_head.") for k in dpt_sd}

    x = rng.randn(50, 384).astype(np.float32)
    want = JaxSegHead().apply(jconvert.load_seg_head(str(paths["seg"])), jnp.asarray(x))
    np.testing.assert_allclose(seg(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    x = rng.randn(50, 768).astype(np.float32)
    want = JaxDepthHead().apply(jconvert.load_depth_head(str(paths["depth"])), jnp.asarray(x))
    np.testing.assert_allclose(depth(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=0)
    taps = _taps(rng, 5, 7)
    want = np.asarray(JaxDPTHead().apply(jconvert.load_dpt_head(str(paths["dpt"])),
                                         [(jnp.asarray(t), jnp.asarray(c)) for t, c in taps]))
    with torch.no_grad():
        got = dpt([(torch.from_numpy(t), torch.from_numpy(c)) for t, c in taps])
    np.testing.assert_allclose(got[:, 0].numpy(), want[..., 0], atol=1e-4 * np.abs(want).max(),
                               rtol=0)
    with pytest.raises(FileNotFoundError):
        _load_head(SegHeadFlatten(), str(tmp_path / "missing.pth"))
