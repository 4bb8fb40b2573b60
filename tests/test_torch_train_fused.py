"""tcnerf_torch stage-1 training of the CLIP-fused configs against the JAX
package on the CPU: the composed configs and the entry points' defaults,
the prefetching feed, the PNG validation strip, and one fused train step
for v0 on 1 and 3 views and for v4 with the dense text gate and elu.

Model sizes are test_torch_fusion.py's (48x64 sources, n_features 256,
hidden 32, 2 blocks, ViT dim 32 at 32^2, CLIP layers (1, 1, 1, 1), width 8,
32^2, embed 32); parameters fill the flax tree from a numpy seed and reach
the port through `from_flax`; the sampling draws are JAX's. Each test names
its bar.
"""

import inspect
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fusion import _draw, _flax_model, _port, _t
from tcnerf.models import training as jtrain
from tcnerf.train import config as jconfig
from tcnerf.train import train_nerf as jtrain_nerf
from tcnerf.train import train_without as jtrain_without
from tcnerf_torch.core.rays import get_specific_rays
from tcnerf_torch.data import generators, loaders
from tcnerf_torch.data.prefetch import prefetch_to_device, prefetched_epochs
from tcnerf_torch.data.synthetic import camera_ring
from tcnerf_torch.models import training
from tcnerf_torch.params import from_flax
from tcnerf_torch.train import config, train_nerf, train_without

ROOT = str(jconfig.__file__).rsplit("/", 2)[0] + "/configs"
H, W, S = 48, 64, 8
CPU = torch.device("cpu")
TINY_CLI = ["nerf_model.original_image_size=[48,64]", "nerf_model.n_samples=4",
            "nerf_model.n_rays_train=8", "nerf_model.vit_size=[32,32]",
            "nerf_model.vit_dim=32", "nerf_model.vit_heads=2",
            "nerf_model.vit_hooks=[1,2,3,4]", "nerf_model.n_blocks=2",
            "nerf_model.hidden_size=32", "nerf_model.clip_layers=[1,1,1,1]",
            "nerf_model.clip_width=8", "nerf_model.clip_embed_dim=32",
            "nerf_model.clip_image_size=32"]


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("name", sorted(config.CONFIGS))
@pytest.mark.parametrize("overrides", [
    [], ["data_dir=/tmp/run", "nerf_model.n_samples=8",
         "+nerf_model.pallas_mlp=true", "seed=3"]])
def test_composed_config_matches_jax(name, overrides):
    """Every carried config composes to the JAX package's YAML dict, with
    and without overrides (and its interpolations resolved alike)."""
    want = jconfig.load_config(ROOT, name, overrides).to_dict()
    assert config.load_config(overrides, name) == want


def _closure(fn, name):
    return inspect.getclosurevars(fn).nonlocals[name]


@pytest.mark.parametrize("module,jmodule,name,fusion", [
    (train_nerf, jtrain_nerf, "nerf_1_view", None),
    (train_without, jtrain_without, "nerf_1_view_wo", "without")])
def test_entry_points_compose_the_reference_defaults(monkeypatch, module,
                                                     jmodule, name, fusion):
    """`python -m tcnerf_torch.train.train_nerf` composes nerf_1_view and
    `train_without` nerf_1_view_wo with fusion "without", as the JAX entry
    points do (their `main_config` names, read from the decorators, and
    the fusion their bodies pass to `_main`); `--config-name=` picks the
    3-view and v4-elu configs."""
    seen = []
    monkeypatch.setattr(train_nerf, "_main",
                        lambda cfg, device=None, fusion=None:
                        seen.append((cfg, fusion)))
    module.main(["data_dir=/tmp/x"])
    assert _closure(jmodule.main, "config_name") == name
    jseen = []
    monkeypatch.setattr(jmodule, "_main",
                        lambda cfg, fusion=None: jseen.append(fusion))
    _closure(jmodule.main, "fn")(None)
    assert seen[0][1] == jseen[0] == fusion
    assert seen[0][0] == jconfig.load_config(ROOT, name,
                                             ["data_dir=/tmp/x"]).to_dict()
    for other in ("nerf_3_view", "nerf_1_view_v4_elu"):
        module.main([f"--config-name={other}"])
        assert seen[-1][0] == jconfig.load_config(ROOT, other).to_dict()


# ------------------------------------------------------------ the feed

def test_prefetched_epochs_keep_the_plain_order(tmp_path):
    """Two epochs through prefetched_epochs equal the plain loop's batches
    (index access, then the epoch-end shuffle) bit for bit, on generators
    of one seed; the producer thread alone draws from the generator."""
    path = str(tmp_path / "ds")
    loaders.ensure_dataset(path, 5, n_samples=6, image_size=(12, 16))
    kw = dict(n_rays_train=10, batch_size=2, n_views=2, shuffle=True, rng=4)
    plain = generators.MVNeRFDataGenerator(loaders.load_dataset_nerf(5, path),
                                           **kw)
    fed = generators.MVNeRFDataGenerator(loaders.load_dataset_nerf(5, path),
                                         **kw)
    want = []
    for _ in range(2):
        for i in range(len(plain)):
            want.append(plain[i])
        plain.on_epoch_end()
    got = list(prefetched_epochs(fed, 2, CPU))
    assert len(got) == len(want) == 6
    for (gi, gl), (wi, wl) in zip(got, want):
        for a, b in zip(gi + (gl,), wi + (wl,)):
            assert isinstance(a, torch.Tensor)
            np.testing.assert_array_equal(a.numpy(), b)
    assert plain.rng.bit_generator.state == fed.rng.bit_generator.state


def test_prefetch_raises_producer_errors_and_stops():
    """An error in the producer reaches the consumer after the batches
    before it; a consumer that stops early ends the producer."""
    def batches():
        yield (np.zeros(3),), np.ones(2)
        raise ValueError("synthesis failed")

    feed = prefetch_to_device(batches(), CPU)
    inputs, labels = next(feed)
    assert labels.tolist() == [1.0, 1.0]
    with pytest.raises(ValueError, match="synthesis failed"):
        next(feed)
    drawn = []

    def endless():
        while True:
            drawn.append(1)
            yield (np.zeros(1),), np.zeros(1)

    feed = prefetch_to_device(endless(), CPU, size=2)
    next(feed)
    feed.close()                # joins the producer
    n = len(drawn)
    time.sleep(0.2)
    assert n <= 4 and len(drawn) == n


def test_validation_strip_png_matches_pil(tmp_path):
    """The stdlib PNG strip decodes (PIL) to the pixels of the JAX
    package's PIL-written strip for the same views, render and depth."""
    from PIL import Image
    rng = np.random.default_rng(0)
    srcs = [rng.integers(0, 256, (H, W, 4), dtype=np.uint8) for _ in range(3)]
    tgt = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    depth = rng.integers(0, 256, (H, W, 1), dtype=np.uint8)
    train_nerf.save_validation_strip(str(tmp_path / "p.png"), srcs, tgt, rgb,
                                     depth)
    jtrain_nerf.save_validation_strip(str(tmp_path / "j.png"), srcs, tgt,
                                      rgb, depth)
    got = np.asarray(Image.open(tmp_path / "p.png"))
    want = np.asarray(Image.open(tmp_path / "j.png"))
    assert got.shape == want.shape == (H, 6 * W, 3)
    np.testing.assert_array_equal(got, want)


def test_fused_trainer_runs_end_to_end_on_the_cpu(tmp_path):
    """`train_nerf` on its default nerf_1_view (fusion v0) at a tiny size,
    fed by the prefetch thread: one step, finite loss, the validation
    strips valid-0.png and valid-1.png (decoded with PIL: source, target,
    render, depth side by side) and two metrics.jsonl lines; the frozen
    CLIP tower untouched and without gradients."""
    from PIL import Image
    cfg = config.load_config([
        "device=cpu", f"data_dir={tmp_path}", *TINY_CLI,
        "nerf_model.n_features=256", "nerf_training.n_epochs=1",
        "nerf_training.eval_after_epochs=1", "dataset.n_perspectives=4",
        "dataset.n_synthetic_samples=1", "valid_sample_idx=0",
        "valid_perspective_src_indices=[0]", "valid_perspective_tgt_idx=2"])
    assert cfg.nerf_training.fusion == "v0"
    assert cfg.nerf_training.batch_size == 1
    state, history = train_nerf._main(cfg)
    model = state.model
    assert model.fusion == "v0" and state.step == 1
    assert np.isfinite(history["steps"][0]["loss"])
    for epoch in (0, 1):
        img = np.asarray(Image.open(os.path.join(
            cfg.nerf_training.model_path, "valid", f"valid-{epoch}.png")))
        assert img.shape == (H, 4 * W, 3)
    with open(os.path.join(cfg.nerf_training.model_path,
                           "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [x["epoch"] for x in lines] == [0, 1]
    assert lines[0]["loss"] is None and np.isfinite(lines[1]["loss"])
    assert all(p.grad is None for p in model.clip_visual.parameters())


# ------------------------------------------------------ fused train step

STEP_CASES = [(1, "v0", False, "relu"), (3, "v0", False, "relu"),
              (1, "v4", True, "elu")]


def _batch(rng, b, n_views, r):
    """A [B, R] ray batch through target pixels, n_views sources on an arc
    around the target, random images and target colours."""
    cfgs = camera_ring(n_views + 1, height=H, width=W, azimuth_span=0.6)
    src, tgt = cfgs[:-1], cfgs[-1]
    k4 = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    k4[:, :3, :3] = [c["intrinsics"].reshape(3, 3) for c in src]
    ext = np.asarray([np.linalg.inv(c["pose"]) for c in src], np.float32)
    ro, rd = zip(*[get_specific_rays(
        rng.uniform(0, W - 1, r), rng.uniform(0, H - 1, r), tgt["pose"],
        tgt["intrinsics"].reshape(3, 3)) for _ in range(b)])
    inputs = (np.stack(ro).astype(np.float32), np.stack(rd).astype(np.float32),
              rng.uniform(size=(b, n_views, H, W, 3)).astype(np.float32),
              np.tile(k4, (b, 1, 1, 1)), np.tile(ext, (b, 1, 1, 1)))
    return inputs, rng.uniform(size=(b, r, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=STEP_CASES,
                ids=["v0-1view", "v0-3view", "v4-dense-elu"])
def jax_step(request):
    """The JAX side of one step, in f64: the loss of `nerf_train_step` (its
    unchunked `loss_fn`: MSE coarse + MSE fine + aux, the sampling key's
    two draws) and its gradients, from `jax.value_and_grad`."""
    n_views, fusion, dense, act = request.param
    kw = dict(fusion=fusion, fusion_use_dense=dense, fusion_activation=act,
              corner_gather=False, remat=True)
    fm, variables, _ = _flax_model(n_views, **kw)
    b = 2 if n_views == 1 else 1
    inputs, labels = _batch(np.random.default_rng(5), b, n_views, 8)
    key = jax.random.PRNGKey(11)

    def loss_fn(p, inputs, labels):
        rgb, _, fine_rgb, _, aux = fm.apply({"params": p}, inputs,
                                            rngs={"sampling": key})
        return jtrain.mse(labels, rgb) + jtrain.mse(labels, fine_rgb) + aux

    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables["params"])
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            p64, tuple(jnp.asarray(x, jnp.float64) for x in inputs),
            jnp.asarray(labels, jnp.float64))
        draws = fm.apply({"params": p64}, b, 8, S, method=_draw,
                         rngs={"sampling": key})
        loss, grads, draws = jax.device_get((loss, grads, draws))
    return dict(n_views=n_views, kw=kw, variables=variables, inputs=inputs,
                labels=labels, loss=float(loss),
                draws=[np.asarray(d) for d in draws],
                grads=from_flax(grads))


@pytest.mark.parametrize("pallas_mlp", [False, True])
def test_fused_train_step_matches_jax(jax_step, pallas_mlp, monkeypatch):
    """One step of the port's `nerf_train_step` (f32, JAX's draws) against
    the JAX step's loss: 1e-3 relative. The step's gradients in f64 (as
    tests/test_torch_train.py compares them: f32 gradients through the PDF
    resampling are ill-conditioned) against JAX's: per group ('nerf',
    'feature') the worst tensor's max|got - want| / max|want| within 1e-3.
    The frozen CLIP tower: bit-identical after the step and without a
    `.grad`. `pallas_mlp` on the CPU runs K1''s plain version (the JAX
    side runs its plain chain)."""
    st = jax_step
    m = _port(st["n_views"], st["variables"], **st["kw"],
              pallas_mlp=pallas_mlp)
    frozen = {n: p.detach().clone() for n, p in m.named_parameters()
              if training.param_group(n) == "frozen"}
    assert frozen and all(n.startswith("clip_visual.") for n in frozen)
    ts = training.create_train_state(
        m, training.make_nerf_optimizer(m, warmup_steps=1))
    monkeypatch.setattr(training, "draw_samples",
                        lambda *a: tuple(_t(d) for d in st["draws"]))
    # the f32 step on the f64 draws rounded to f32
    _, metrics = training.nerf_train_step(
        ts, tuple(map(_t, st["inputs"])), _t(st["labels"]))
    np.testing.assert_allclose(float(metrics["loss"]), st["loss"], rtol=1e-3)
    for n, p in m.named_parameters():
        if n in frozen:
            assert p.grad is None, n
            assert torch.equal(p.detach(), frozen[n]), n

    m64 = _port(st["n_views"], st["variables"], **st["kw"],
                pallas_mlp=pallas_mlp).double()
    loss = training.nerf_loss(
        m64, tuple(_t(x).double() for x in st["inputs"]),
        _t(st["labels"]).double(),
        *(torch.as_tensor(d) for d in st["draws"]))
    loss.backward()
    top = max(float(g.abs().max()) for n, g in st["grads"].items()
              if training.param_group(n) != "frozen")
    worst = {}
    for n, p in m64.named_parameters():
        group = training.param_group(n)
        if group == "frozen":
            assert p.grad is None, n
            continue
        want = st["grads"][n].double()
        scale = float(want.abs().max())
        # gradients that are zero in exact arithmetic (a bias before a
        # batch-statistics norm) are held at 1e-9 of the largest
        if scale <= 1e-9 * top:
            assert float(p.grad.abs().max()) <= 1e-9 * top, n
            continue
        err = float((p.grad - want).abs().max()) / scale
        worst[group] = max(worst.get(group, 0.0), err)
    assert set(worst) == {"nerf", "feature"}
    assert max(worst.values()) <= 1e-3, worst
