"""Reference checkpoints (``models.convert.load_torch_checkpoint``) and the
last two parts of CDVNet, the score head and the DINO adapter.

A ``.pth`` is written from a seeded random port network the way a
reference training run saves one (a ``module.`` prefix, an
``update.lmbda`` entry). The port loads it back exactly (bitwise), and
the JAX package's loader, carried back through ``load_flax_params``, gives
the same state dict (bitwise: both are transposes of the same arrays). The
score head (``compute_score``) and the adapter (``dino_adapt``) are held
to the flax ``CDVNet(compute_score=True, dino_adapt=True)`` on the same
inputs within 1e-5, and the score map through DINO within 2e-4 (DINO's
own tolerance, ``test_torch_models.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdvslam_tpu.models import convert as jconvert
from cdvslam_tpu.models.cdvnet import CDVNet as JCDVNet
from cdvslam_tpu_torch.models import CDVNet, VONet
from cdvslam_tpu_torch.models.convert import load_flax_params, load_torch_checkpoint

torch.set_num_threads(2)


def _save_reference(net, path):
    """Save net's state as a reference DataParallel run would."""
    sd = {f"module.{k}": v.clone() for k, v in net.state_dict().items()}
    sd["module.update.lmbda"] = torch.tensor([1e-4])
    torch.save(sd, path)


def _random(cls, seed, **kw):
    torch.manual_seed(seed)
    net = cls(**kw).eval()
    with torch.no_grad():      # move the zero-initialised leaves off zero
        for p in net.parameters():
            p.add_(0.02 * torch.randn_like(p))
    return net


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    net = _random(CDVNet, 3, compute_score=True, dino_adapt=True)
    path = tmp_path_factory.mktemp("ckpt") / "cdvslam.pth"
    _save_reference(net, path)
    return net, path


def test_cdv_checkpoint_loads_back_exactly_and_as_the_jax_loader_reads_it(tmp_path):
    net = _random(CDVNet, 1)
    path = tmp_path / "cdvo.pth"
    _save_reference(net, path)
    sd, aside = load_torch_checkpoint(path, "cdv")
    assert aside == {}
    want = net.state_dict()
    assert sd.keys() == want.keys()
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    back = CDVNet().eval()
    back.load_state_dict(sd)          # strict
    via_jax = load_flax_params(jax.tree_util.tree_map(
        np.asarray, jconvert.load_torch_checkpoint(str(path), version="cdv")))
    assert via_jax.keys() == want.keys()
    for k in want:
        assert torch.equal(via_jax[k], want[k]), k


def test_dpv_checkpoint_loads_back_exactly(tmp_path):
    net = _random(VONet, 2)
    path = tmp_path / "dpvo.pth"
    _save_reference(net, path)
    sd, aside = load_torch_checkpoint(path, "dpv")
    assert aside == {} and sd.keys() == net.state_dict().keys()
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_score_head_and_adapter_are_set_aside_and_fill_the_full_network(scored):
    net, path = scored
    sd, aside = load_torch_checkpoint(path, "cdv")
    assert sorted(aside) == ["patchify.dino_adapter.weight", "patchify.score.0.bias",
                             "patchify.score.0.weight", "patchify.score.2.bias",
                             "patchify.score.2.weight"]
    CDVNet().load_state_dict(sd)                                  # the runtime's network
    full = CDVNet(compute_score=True, dino_adapt=True)
    full.load_state_dict({**sd, **aside})
    for k, v in net.state_dict().items():
        assert torch.equal(full.state_dict()[k], v), k


@pytest.mark.parametrize("edit", ["missing", "unknown", "shape"])
def test_a_checkpoint_that_does_not_fit_raises(tmp_path, edit):
    sd = {k: v.clone() for k, v in CDVNet().state_dict().items()}
    if edit == "missing":
        sd.pop("posenc.Wr.weight")
    elif edit == "unknown":
        sd["patchify.extra.weight"] = torch.zeros(3)
    else:
        sd["posenc.Wr.weight"] = torch.zeros(5, 5)
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="does not fit"):
        load_torch_checkpoint(tmp_path / "bad.pth", "cdv")


def _flax(path):
    tree = jax.tree_util.tree_map(jnp.asarray, jconvert.load_torch_checkpoint(str(path)))
    return JCDVNet(compute_score=True, dino_adapt=True), tree


def test_score_head_and_adapter_match_flax(scored):
    net, path = scored
    jm, tree = _flax(path)
    rng = np.random.default_rng(7)
    tokens = rng.standard_normal((1, 20, 384)).astype(np.float32)
    ictx = rng.standard_normal((1, 8, 384)).astype(np.float32)
    ref_score = jm.apply(tree, jnp.asarray(tokens), method=lambda m, t: m.score_head(t))
    ref_adapt = jm.apply(tree, jnp.asarray(ictx), method=JCDVNet.adapt)
    with torch.no_grad():
        score = net.patchify.score(torch.from_numpy(tokens))
        adapt = net.adapt(torch.from_numpy(ictx))
    assert score.shape == (1, 20, 1) and adapt.shape == (1, 8, 384)
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_score), rtol=0, atol=1e-5)
    np.testing.assert_allclose(adapt.numpy(), np.asarray(ref_adapt), rtol=0, atol=1e-5)
    assert float(score.std()) > 1e-3 and float((adapt - torch.from_numpy(ictx)).abs().max()) > 0.1


def test_score_map_through_dino_matches_flax(scored):
    net, path = scored
    jm, tree = _flax(path)
    img = np.random.default_rng(8).uniform(0, 1, (1, 48, 64, 3)).astype(np.float32)
    ref = jm.apply(tree, jnp.asarray(img), method=JCDVNet.features_i)[4]
    with torch.no_grad():
        out = net.features_i(torch.from_numpy(img))[4]
        assert CDVNet().features_i(torch.from_numpy(img))[4] is None
    assert out.shape == (1, 4, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
