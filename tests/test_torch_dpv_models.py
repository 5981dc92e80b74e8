"""The DPVO network's modules in the port against the flax modules, and the
DPVO patch selection against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both sides; everything
runs in float32. Tolerances: 1e-4 absolute and relative (2e-4 for the
update operator, whose SoftAggs and LayerNorms stack) -- both sides compute
the same float32 expressions, and what differs is the summation order
inside matmuls, convolutions and the instance norm's statistics. The
selections take the JAX draws as their candidates and must give the same
coordinates exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdvslam_tpu.models import blocks as jblocks
from cdvslam_tpu.models import convert as jconvert
from cdvslam_tpu.models import patchifier as jpatch
from cdvslam_tpu.models.encoder import BasicEncoder4 as JEncoder
from cdvslam_tpu.models.update import UpdateDPV as JUpdateDPV
from cdvslam_tpu.models.update import build_update_aux as jbuild_aux
from cdvslam_tpu.models.vonet import VONet as JVONet
from cdvslam_tpu_torch.models import VONet, build_update_aux
from cdvslam_tpu_torch.models.blocks import GatedResidual
from cdvslam_tpu_torch.models.convert import (
    encoder4_state, gated_residual_state, update_dpv_state, vonet_state,
)
from cdvslam_tpu_torch.models.encoder import BasicEncoder4
from cdvslam_tpu_torch.models.patchifier import (
    extract_patches, image_gradient, random_candidates, select_gradient_bias, select_random,
)
from cdvslam_tpu_torch.models.update import UpdateDPV

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, rng, scale=0.2):
    """Random values everywhere (flax inits leave biases and LayerNorms at
    0/1, which would hide a transposed parameter)."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def _close(a, b, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=atol, rtol=rtol)


def _image(rng, H=64, W=96):
    """A DPVO-preprocessed random frame (1, H, W, 3)."""
    u8 = rng.integers(0, 256, (1, H, W, 3)).astype(np.float32)
    return (2.0 * (u8 / 255.0) - 0.5).astype(np.float32)


@pytest.mark.parametrize("norm_fn,dim", [("instance", 128), ("none", 384)])
def test_basic_encoder4_matches_flax(norm_fn, dim):
    rng = np.random.default_rng(0)
    img = _image(rng)
    mod = JEncoder(output_dim=dim, norm_fn=norm_fn)
    p = _perturb(_np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"]), rng, 0.05)
    ref = mod.apply({"params": p}, jnp.asarray(img))                # (1, 16, 24, dim)
    enc = BasicEncoder4(dim, norm_fn).eval()
    enc.load_state_dict(encoder4_state(p, ""))
    with torch.no_grad():
        out = enc(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert out.shape == (1, dim, 16, 24)
    _close(out.permute(0, 2, 3, 1), ref)
    # the converter's inverse: the port's state dict through the JAX package's
    sd = {k: v.numpy() for k, v in enc.state_dict().items()}
    back = jconvert.convert_encoder4(sd, "", norm_fn)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, p)


def test_instance_norm_epsilon_gap_on_the_test_input():
    """The JAX package's epsilon (1e-6, flax GroupNorm) against the
    reference's InstanceNorm2d (1e-5) on the encoder's first norm input of
    a seeded encoder: 1.9e-4 at most (measured), above the 1e-4 the port
    is held to, so the port takes the JAX package's 1e-6 (ROADMAP Queue 3
    records the gap)."""
    rng = np.random.default_rng(0)
    img = torch.from_numpy(_image(rng)).permute(0, 3, 1, 2)
    torch.manual_seed(0)
    enc = BasicEncoder4(128, "instance").eval()
    with torch.no_grad():
        x = enc.conv1(img)
        gap = (torch.nn.functional.instance_norm(x, eps=1e-6)
               - torch.nn.functional.instance_norm(x, eps=1e-5)).abs().max().item()
    assert 1e-4 < gap < 1e-3


def test_gated_residual_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 50, 384)).astype(np.float32)
    mod = jblocks.GatedResidual(384)
    p = _perturb(_np_tree(mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]), rng, 0.05)
    ref = mod.apply({"params": p}, jnp.asarray(x))
    gr = GatedResidual(384).eval()
    gr.load_state_dict(gated_residual_state(p))
    with torch.no_grad():
        out = gr(torch.from_numpy(x))
    _close(out, ref)


def _edges(n_frames, M, rng):
    """A small patch graph: frames to their neighbours within 2, M patches
    each, shuffled, so several (i, j) groups interleave."""
    ii, jj, kk = [], [], []
    for i in range(n_frames):
        for j in range(max(i - 2, 0), min(i + 3, n_frames)):
            ii += [i] * M
            jj += [j] * M
            kk += list(range(i * M, (i + 1) * M))
    perm = rng.permutation(len(ii))
    return np.asarray(ii)[perm], np.asarray(jj)[perm], np.asarray(kk)[perm]


def _update_params(rng, E=8):
    aux = jbuild_aux(np.zeros(E, np.int64), np.arange(E), np.arange(E), 0, 16, E_pad=E)
    z = jnp.zeros((1, E, 384))
    p = JUpdateDPV().init(jax.random.PRNGKey(2), z, z, jnp.zeros((1, E, 882)), aux, 16, E)
    return _perturb(_np_tree(p["params"]), rng, 0.05)


@pytest.mark.parametrize("pad", [0, 13])
def test_update_dpv_matches_flax(pad):
    """Several (i, j) groups, and with pad > 0 masked padding edges as the
    JAX runtime sends them (n_gseg = E_pad)."""
    rng = np.random.default_rng(3)
    M, nf = 4, 5
    ii, jj, kk = _edges(nf, M, rng)
    E = len(ii)
    E_pad, n_kseg = E + pad, nf * M
    net, inp = (rng.standard_normal((1, E_pad, 384)).astype(np.float32) for _ in range(2))
    corr = rng.standard_normal((1, E_pad, 882)).astype(np.float32)
    p = _update_params(rng)
    jaux = jbuild_aux(ii, jj, kk, 0, n_kseg, n_gseg=E_pad, E_pad=E_pad)
    assert len(np.unique(np.asarray(jaux.gseg)[:E])) == 19      # the (i, j) pairs
    rnet, rd, rw = JUpdateDPV().apply({"params": p}, jnp.asarray(net), jnp.asarray(inp),
                                      jnp.asarray(corr), jaux, n_kseg, E_pad)
    aux = build_update_aux(ii, jj, kk, 0, n_kseg, n_gseg=E_pad, E_pad=E_pad)
    upd = UpdateDPV().eval()
    upd.load_state_dict(update_dpv_state(p, prefix=""))
    with torch.no_grad():
        tnet, td, tw = upd(torch.from_numpy(net), torch.from_numpy(inp), torch.from_numpy(corr),
                           aux.to_torch("cpu"), n_kseg, E_pad)
    # padded rows are garbage on both sides and masked downstream
    _close(tnet[:, :E], np.asarray(rnet)[:, :E], atol=2e-4, rtol=2e-4)
    _close(td[:, :E], np.asarray(rd)[:, :E])
    _close(tw[:, :E], np.asarray(rw)[:, :E])


def _jax_vonet(rng, img):
    """The JAX VONet's variables as the JAX SLAM builds them, perturbed."""
    feats = JVONet().init(jax.random.PRNGKey(4), jnp.asarray(img), method=JVONet.features)
    params = _perturb(_np_tree(feats["params"]), rng, 0.05)
    params["update_op"] = _update_params(rng)
    return {"params": params}


def test_vonet_features_matches_flax():
    rng = np.random.default_rng(4)
    img = _image(rng)
    tree = _jax_vonet(rng, img)
    rf, ri = JVONet().apply(tree, jnp.asarray(img), method=JVONet.features)
    net = VONet().eval()
    net.load_state_dict(vonet_state(tree))
    with torch.no_grad():
        f, i = net.features(torch.from_numpy(img))
    assert f.shape == (1, 128, 16, 24) and i.shape == (1, 384, 16, 24)
    _close(f, rf)
    _close(i, ri)


def test_vonet_state_round_trip():
    """A seeded port VONet's state dict through the JAX package's
    convert_encoder4 / convert_update_dpv and back through vonet_state
    gives the same tensors, except that each gated residual's res.0 and
    res.2 trade places: the JAX converter maps res.0 (which the reference
    and the port apply first) to the Dense that flax applies second
    (ROADMAP Queue 3). On the converted weights the flax features equal
    the port's; the flax update operator equals the port's loaded through
    vonet_state, and differs from the port's own."""
    torch.manual_seed(5)
    net = VONet().eval()
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    tree = {"params": {"fnet": jconvert.convert_encoder4(sd, "patchify.fnet.", "instance"),
                       "inet": jconvert.convert_encoder4(sd, "patchify.inet.", "none"),
                       **jconvert.convert_update_dpv(sd)}}
    back = vonet_state(tree)
    assert sorted(back) == sorted(sd)
    swap = {f"update.gru.{i}.res.{a}.{w}": f"update.gru.{i}.res.{b}.{w}"
            for i in (1, 3) for a, b in ((0, 2), (2, 0)) for w in ("weight", "bias")}
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[swap.get(k, k)], err_msg=k)

    rng = np.random.default_rng(5)
    img = _image(rng)
    rf, ri = JVONet().apply(tree, jnp.asarray(img), method=JVONet.features)
    with torch.no_grad():
        f, i = net.features(torch.from_numpy(img))
    _close(f, rf)
    _close(i, ri)

    ii, jj, kk = _edges(4, 4, rng)
    E = len(ii)
    x = [rng.standard_normal((1, E, c)).astype(np.float32) for c in (384, 384, 882)]
    jaux = jbuild_aux(ii, jj, kk, 0, 16, n_gseg=E)
    _, rd, _ = JUpdateDPV().apply({"params": tree["params"]["update_op"]},
                                  *map(jnp.asarray, x), jaux, 16, E)
    aux = build_update_aux(ii, jj, kk, 0, 16, n_gseg=E).to_torch("cpu")
    converted = VONet().eval()
    converted.load_state_dict(back)
    with torch.no_grad():
        _, td, _ = converted.update(*map(torch.from_numpy, x), aux, 16, E)
        _, own, _ = net.update(*map(torch.from_numpy, x), aux, 16, E)
    _close(td, rd)
    assert np.abs(own.numpy() - np.asarray(rd)).max() > 1e-2


def _tie_frame(H=64, W=96):
    """A frame of flat 8 x 8 blocks: every 4 x 4 gradient cell away from a
    block edge is 0, and the cells along the edges repeat a few values, so
    most candidates tie with others."""
    rng = np.random.default_rng(6)
    blocks = rng.integers(0, 4, (H // 8, W // 8, 1)) * 60
    u8 = np.repeat(np.repeat(blocks, 8, 0), 8, 1).repeat(3, 2).astype(np.float32)
    return (2.0 * (u8 / 255.0) - 0.5)[None].astype(np.float32)


@pytest.mark.parametrize("frame", ["random", "ties"])
def test_image_gradient_matches_jax_exactly(frame):
    img = _image(np.random.default_rng(7)) if frame == "random" else _tie_frame()
    ref = np.asarray(jax.jit(jpatch.image_gradient)(jnp.asarray(img[None])))
    out = image_gradient(torch.from_numpy(img[None])).numpy()
    assert out.shape == ref.shape == (1, 1, 15, 23)
    np.testing.assert_array_equal(out, ref)


def _jax_candidates(key, n, K, h, w):
    """The draws JAX's select_random / select_gradient_bias make from key."""
    kx, ky = jax.random.split(key)
    x = jax.random.randint(kx, (n, K), 1, w - 1)
    y = jax.random.randint(ky, (n, K), 1, h - 1)
    return torch.from_numpy(np.asarray(x, np.int64)), torch.from_numpy(np.asarray(y, np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_random_matches_jax_on_its_candidates(seed):
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.jit(jpatch.select_random, static_argnums=(1, 2, 3, 4))(
        key, 1, 96, 16, 24))
    out = select_random(*_jax_candidates(key, 1, 96, 16, 24)).numpy()
    np.testing.assert_array_equal(out, ref)
    # the port's own draws: integer centres inside [1, dim - 1)
    x, y = random_candidates(torch.Generator().manual_seed(seed), 2, 500, 16, 24)
    assert x.shape == y.shape == (2, 500)
    assert int(x.min()) == 1 and int(x.max()) == 22 and int(y.min()) == 1 and int(y.max()) == 14


@pytest.mark.parametrize("frame,seed", [("random", 0), ("random", 1), ("ties", 0), ("ties", 1)])
def test_select_gradient_bias_matches_jax_on_its_candidates(frame, seed):
    """The same coordinates in the same order; on the block frame most of
    the 3M candidates tie, and the stable sort's order decides."""
    img = _image(np.random.default_rng(8 + seed)) if frame == "random" else _tie_frame()
    key = jax.random.PRNGKey(seed)
    M, h, w = 32, 16, 24
    ref = np.asarray(jax.jit(jpatch.select_gradient_bias, static_argnums=(2, 3, 4))(
        key, jnp.asarray(img[None]), M, h, w))
    x, y = _jax_candidates(key, 1, 3 * M, h, w)
    out = select_gradient_bias(x, y, torch.from_numpy(img[None]), M).numpy()
    assert out.shape == (1, M, 2)
    np.testing.assert_array_equal(out, ref)
    if frame == "ties":
        g = image_gradient(torch.from_numpy(img[None]))[0, 0]
        vals = g[y[0], x[0]]
        kept = vals[torch.argsort(vals, stable=True)[-M:]]
        assert (kept[:, None] == kept[None, :]).sum() > 2 * M    # ties among the kept


def test_extract_patches_matches_jax():
    rng = np.random.default_rng(9)
    fmap = rng.standard_normal((1, 128, 16, 24)).astype(np.float32)
    imap = rng.standard_normal((1, 384, 16, 24)).astype(np.float32)
    img = _image(rng)
    disps = np.ones((1, 16, 24), np.float32)
    x, y = _jax_candidates(jax.random.PRNGKey(9), 1, 40, 16, 24)
    coords = select_random(x, y)
    ref = jpatch.extract_patches(jnp.asarray(fmap), jnp.asarray(imap), jnp.asarray(img),
                                 jnp.asarray(disps), jnp.asarray(coords.numpy()), P=3)
    out = extract_patches(torch.from_numpy(fmap), torch.from_numpy(imap),
                          torch.from_numpy(img), torch.from_numpy(disps), coords, P=3)
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
