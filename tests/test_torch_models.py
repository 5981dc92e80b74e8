"""Port networks against the flax modules, with the same converted weights.

Inputs are made with numpy from a seed and fed to both sides; everything
runs in float32 on the CPU. Tolerances: 1e-4 absolute (2e-4 relative for
the deep stacks) -- both sides compute the same float32 expressions, and
what differs is the summation order inside matmuls and convolutions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdvslam_tpu.models import attention as jatt
from cdvslam_tpu.models import convert as jconvert
from cdvslam_tpu.models.cdvnet import CDVNet as JCDVNet
from cdvslam_tpu.models.dinov2 import DinoVisionTransformer as JDino
from cdvslam_tpu.models.update import UpdateAux as JAux
from cdvslam_tpu.models.update import UpdateCDV as JUpdate
from cdvslam_tpu.models.update import build_update_aux as jbuild_aux
from cdvslam_tpu.models.xfeat import XFeatF as JXFeatF
from cdvslam_tpu_torch.models import CDVNet, build_update_aux
from cdvslam_tpu_torch.models.attention import GatedAttention
from cdvslam_tpu_torch.models.convert import (
    dino_state, load_flax_params, update_cdv_state, xfeat_state)
from cdvslam_tpu_torch.models.dinov2 import DinoVisionTransformer
from cdvslam_tpu_torch.models.update import UpdateCDV
from cdvslam_tpu_torch.models.xfeat import XFeat, xfeat_f

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, rng, scale=0.2):
    """Random values everywhere (flax inits leave biases, LayerNorm and
    BatchNorm stats at 0/1, which would hide a transposed parameter)."""
    def f(a):
        a = np.asarray(a)
        return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map(f, tree)


def _close(a, b, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=atol, rtol=rtol)


def test_xfeat_matches_flax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32)
    v = JXFeatF().init(jax.random.PRNGKey(0), jnp.asarray(img))
    v = {"params": _perturb(v["params"], rng),
         "batch_stats": jax.tree_util.tree_map(
             lambda a: np.abs(np.asarray(a) + rng.standard_normal(a.shape)).astype(np.float32) + 0.5,
             v["batch_stats"])}
    ref = JXFeatF().apply(v, jnp.asarray(img))                       # (1,h,w,24)
    trunk = XFeat().eval()
    trunk.load_state_dict(xfeat_state(v["params"]["xfeat"], v["batch_stats"]["xfeat"], prefix=""))
    with torch.no_grad():
        out = xfeat_f(trunk, torch.from_numpy(img))
    _close(out.permute(0, 2, 3, 1), ref)


def test_dino_matches_flax_with_resized_pos_embed():
    # 56 x 84 -> a 4 x 6 token grid: the 37 x 37 pos-embed is really resized
    rng = np.random.default_rng(1)
    img = rng.standard_normal((1, 56, 84, 3)).astype(np.float32)
    jd = JDino(depth=3)
    p = _perturb(jd.init(jax.random.PRNGKey(1), jnp.asarray(img), taps=(0, 2)), rng, 0.05)
    ref = jd.apply(p, jnp.asarray(img), taps=(0, 2))
    # the final norm is not part of __call__, so flax does not create it
    norm = {"scale": rng.standard_normal(384).astype(np.float32),
            "bias": rng.standard_normal(384).astype(np.float32)}
    td = DinoVisionTransformer(depth=3).eval()
    td.load_state_dict(dino_state({**p["params"], "norm": norm}, prefix="", depth=3))
    with torch.no_grad():
        out = td(torch.from_numpy(img).permute(0, 3, 1, 2), taps=(0, 2))
    assert len(out) == 2 and out[0].shape == (1, 25, 384)
    for o, r in zip(out, ref):
        _close(o, r, atol=2e-4, rtol=2e-4)


def test_gated_attention_matches_flax():
    rng = np.random.default_rng(2)
    G, M, D = 3, 8, 384
    x = rng.standard_normal((G, M, D)).astype(np.float32)
    enc = rng.standard_normal((2, G, 1, M, D // 8)).astype(np.float32)
    mod = jatt.GatedAttention(D)
    p = _perturb(mod.init(jax.random.PRNGKey(2), jnp.asarray(x), encoding=jnp.asarray(enc)),
                 rng, 0.05)
    ref = mod.apply(p, jnp.asarray(x), encoding=jnp.asarray(enc))
    sd = update_cdv_state(_fake_update_tree(p["params"]), prefix="")
    ga = GatedAttention(D).eval()
    ga.load_state_dict({k[len("gatten."):]: v for k, v in sd.items()
                        if k.startswith("gatten.")})
    with torch.no_grad():
        out = ga(torch.from_numpy(x), encoding=torch.from_numpy(enc))
    _close(out, ref)


def _fake_update_tree(gatten):
    """Wrap a GatedAttention subtree in a dummy update_op tree so that
    update_cdv_state can name its entries."""
    z = {"kernel": np.zeros((1, 1), np.float32), "bias": np.zeros(1, np.float32)}
    ln = {"scale": np.zeros(1, np.float32), "bias": np.zeros(1, np.float32)}
    mlp = {"Dense_0": z, "Dense_1": z}
    common = {"corr_0": z, "corr_2": z, "corr_3": ln, "corr_5": z, "norm": ln,
              "c1": mlp, "c2": mlp,
              "agg_kk": {"Dense_0": z, "Dense_1": z, "Dense_2": z}}
    return {"common": common, "norm2": ln, "gatten": gatten,
            "heads": {"d": z, "w": z}}


def _edges(n_frames, M, rng):
    """A small patch graph with several (i, j) groups of M edges each."""
    ii, jj, kk = [], [], []
    for i in range(n_frames):
        for j in range(max(i - 2, 0), min(i + 3, n_frames)):
            ii += [i] * M
            jj += [j] * M
            kk += list(range(i * M, (i + 1) * M))
    perm = rng.permutation(len(ii))
    return np.asarray(ii)[perm], np.asarray(jj)[perm], np.asarray(kk)[perm]


@pytest.mark.parametrize("pad", [0, 16])
def test_update_cdv_matches_flax(pad):
    rng = np.random.default_rng(3)
    M, nf = 4, 4
    ii, jj, kk = _edges(nf, M, rng)
    E = len(ii)
    n_kseg = nf * M
    E_pad = E + pad
    net = rng.standard_normal((1, E_pad, 384)).astype(np.float32)
    inp = rng.standard_normal((1, E_pad, 384)).astype(np.float32)
    corr = rng.standard_normal((1, E_pad, 2 * 49 * 9)).astype(np.float32)
    posenc = rng.standard_normal((2, 1, 1, E_pad, 48)).astype(np.float32)
    jaux = jbuild_aux(ii, jj, kk, 0, n_kseg, M=M, E_pad=E_pad)
    mod = JUpdate()
    p = _perturb(mod.init(jax.random.PRNGKey(3), jnp.asarray(net), jnp.asarray(inp),
                          jnp.asarray(corr), jaux, n_kseg, posenc=jnp.asarray(posenc)),
                 rng, 0.05)
    rnet, rd, rw = mod.apply(p, jnp.asarray(net), jnp.asarray(inp), jnp.asarray(corr),
                             jaux, n_kseg, posenc=jnp.asarray(posenc))

    aux = build_update_aux(ii, jj, kk, 0, n_kseg, M=M, E_pad=E_pad)
    for name in JAux._fields[:7]:
        np.testing.assert_array_equal(np.asarray(getattr(aux, name)),
                                      np.asarray(getattr(jaux, name)))
    upd = UpdateCDV().eval()
    upd.load_state_dict(update_cdv_state(p["params"], prefix=""))
    with torch.no_grad():
        tnet, td, tw = upd(torch.from_numpy(net), torch.from_numpy(inp),
                           torch.from_numpy(corr), aux.to_torch("cpu"), n_kseg,
                           posenc=torch.from_numpy(posenc))
    # padded rows are garbage on both sides and masked downstream
    _close(tnet[:, :E], np.asarray(rnet)[:, :E], atol=2e-4, rtol=2e-4)
    _close(td[:, :E], np.asarray(rd)[:, :E])
    _close(tw[:, :E], np.asarray(rw)[:, :E])


@pytest.fixture(scope="module")
def cdvnet_pair():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (1, 48, 64, 3)).astype(np.float32)
    jm = JCDVNet()
    k = jax.random.split(jax.random.PRNGKey(4), 3)
    pf = jm.init(k[0], jnp.asarray(img), method=JCDVNet.features_f)
    pi = jm.init(k[1], jnp.asarray(img), method=JCDVNet.features_i)
    pp = jm.init(k[2], jnp.zeros((1, 5, 2)), method=JCDVNet.posenc)
    params = {**_np_tree(pf["params"]), **_np_tree(pi["params"]), **_np_tree(pp["params"])}
    params = _perturb(params, rng, 0.02)
    # a zero-weight update operator completes the tree for the converter
    pu = JUpdate().init(
        jax.random.PRNGKey(5), jnp.zeros((1, 4, 384)), jnp.zeros((1, 4, 384)),
        jnp.zeros((1, 4, 882)), jbuild_aux(np.zeros(4, int), np.arange(4), np.arange(4),
                                           0, 4, M=4), 4)
    params["update_op"] = _np_tree(pu["params"])
    tree = {"params": params, "batch_stats": _np_tree(pf["batch_stats"])}
    net = CDVNet().eval()
    net.load_state_dict(load_flax_params(tree))
    return jm, tree, net, img


def test_cdvnet_features_f_matches_flax(cdvnet_pair):
    jm, tree, net, img = cdvnet_pair
    ref = jm.apply(tree, jnp.asarray(img), method=JCDVNet.features_f)
    with torch.no_grad():
        out = net.features_f(torch.from_numpy(img))
    assert out.shape == (1, 24, 12, 16)
    _close(out, ref)


def test_cdvnet_features_i_matches_flax(cdvnet_pair):
    jm, tree, net, img = cdvnet_pair
    ref = jm.apply(tree, jnp.asarray(img), method=JCDVNet.features_i)
    with torch.no_grad():
        out = net.features_i(torch.from_numpy(img))
    assert out[0].shape == (1, 384, 4, 5)
    for o, r in zip(out[:4], ref[:4]):
        _close(o, r, atol=2e-4, rtol=2e-4)


def test_cdvnet_features_i_taps_matches_flax(cdvnet_pair):
    """features_i's outputs from the same DINO pass, plus the four raw taps."""
    jm, tree, net, img = cdvnet_pair
    ref = jm.apply(tree, jnp.asarray(img), method=JCDVNet.features_i_taps)
    with torch.no_grad():
        out = net.features_i_taps(torch.from_numpy(img))
        plain = net.features_i(torch.from_numpy(img))
    assert all(torch.equal(a, b) for a, b in zip(out[:4], plain[:4]))
    assert len(out[5]) == 4
    for (t, c), (rt, rc) in zip(out[5], ref[5]):
        assert t.shape == (1, 4, 5, 384) and c.shape == (1, 384)
        _close(t, rt, atol=2e-4, rtol=2e-4)
        _close(c, rc, atol=2e-4, rtol=2e-4)


def test_cdvnet_posenc_matches_flax(cdvnet_pair):
    jm, tree, net, _ = cdvnet_pair
    p_n = np.random.default_rng(6).uniform(-1, 1, (1, 5, 2)).astype(np.float32)
    ref = jm.apply(tree, jnp.asarray(p_n), method=JCDVNet.posenc)
    with torch.no_grad():
        out = net.posenc(torch.from_numpy(p_n))
    assert out.shape == (2, 1, 1, 5, 48)
    _close(out, ref)


def test_weights_round_trip_through_reference_converters(cdvnet_pair):
    """flax tree -> load_flax_params -> state_dict -> the JAX package's own
    converters gives back the same arrays."""
    _, tree, net, _ = cdvnet_pair
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    xp, xs = jconvert.convert_xfeat(sd)
    back = {"xfeat_f": {"xfeat": xp}, "dino": jconvert.convert_dino(sd),
            **jconvert.convert_update_cdv(sd),
            "posenc_mod": {"Dense_0": jconvert._lin(sd, "posenc.Wr")}}
    flat_a = jax.tree_util.tree_leaves_with_path(tree["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(a), flat_b[path])
    for path, a in jax.tree_util.tree_leaves_with_path(tree["batch_stats"]["xfeat_f"]["xfeat"]):
        b = dict(jax.tree_util.tree_leaves_with_path(xs))[path]
        np.testing.assert_array_equal(np.asarray(a), b)
