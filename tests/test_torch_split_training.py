"""Training over the mesh's ``model`` axis (tiny, fp32, CPU): gloo ranks in
subprocesses against one process and the JAX trainer.

One session of two ranks at ``mesh_model=2`` takes one step of each case
(LoRA, full fine-tuning with remat, ControlNet, LCM-LoRA distillation,
SDXL's LoRA with its ``time_ids``, SD3's flow LoRA over both streams),
runs ``run_training`` at ``mesh_data: 1, mesh_model: 2`` and checks that
the in-place collectives refuse a tensor that requires grad; one session
of four ranks takes the LoRA step at ``mesh_data: 2, mesh_model: 2``.
Each case's code (``_CASES``) runs alike here, in one process, and on the
ranks.  Gates: every trainable tensor's gradient within 1e-5 (the
distiller's 1e-4, see GRAD_TOL) of one
process's (of its largest magnitude, or of a hundredth of the case's
largest where a tensor's own gradient is fp32 noise about zero, as a
conv bias before a GroupNorm has), the updated tensors as Adam allows
(``torch_parity.assert_adam_close``: an entry whose gradient lies within
fp32 noise of zero may step the other way), losses within 1e-5; every
case's loss and gradients within 2e-4 of the JAX trainer's (or
distiller's) loss function on the same weights, trainables, latents and
draws; the saved files equal one process's in keys and shapes and
Adam-close in values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks
from test_torch_train_loop import _config
from test_torch_distillation import _jax_loss as _jax_distill_loss
from test_torch_training import jax_draws, np_tree
from torch_parity import (assert_adam_close, randn, step_lrs, tiny_engines, tiny_family_engines,
                          tiny_sd3_engines)
from sonicdiffusionbayeslab_torch.config import ConfigNode, validate_config
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
from sonicdiffusionbayeslab_torch.training import loop as TLoop
from sonicdiffusionbayeslab_torch.training.trainer import leaves
from sonicdiffusionbayeslab_tpu.training import distillation as JD
from sonicdiffusionbayeslab_tpu.training import lora as JL
from sonicdiffusionbayeslab_tpu.training import trainer as JT

CASES = ("lora", "full_remat", "controlnet", "distill", "sdxl_lora", "sd3_lora")
LR = {"lora": 1e-3, "full_remat": 1e-4, "controlnet": 1e-4, "distill": 1e-3, "sdxl_lora": 1e-3,
      "sd3_lora": 1e-3}
LOOP = {"lora_rank": 4, "learning_rate": 1e-2, "prefetch": 0, "num_steps": 2}
# The distiller's gradient divides by sqrt((f_on - f_tgt)^2 + c^2) (the
# pseudo-Huber loss, c = 1e-3) and its teacher's DDIM step by sqrt(acp):
# one process's own summation order moves it at 8.4e-5 here, so it is
# held at the repo's one-step tolerance for the distiller (1e-4 relative,
# tests/test_torch_distillation.py).
GRAD_TOL = {"distill": 1e-4}

_CASES = """
import torch
from sonicdiffusionbayeslab_torch.models import sampler as TS
from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
from sonicdiffusionbayeslab_torch.models.mmdit import MMDiTConfig
from sonicdiffusionbayeslab_torch.models.sd3 import SD3Engine
from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
from sonicdiffusionbayeslab_torch.parallel.mesh import batch_sharding
from sonicdiffusionbayeslab_torch.training import lora as TL
from sonicdiffusionbayeslab_torch.training.distillation import LCMDistillConfig, LCMDistiller
from sonicdiffusionbayeslab_torch.training.trainer import DiffusionTrainer, TrainConfig, leaves

def engine(family, sds):
    kw = dict(dtype=torch.float32, device="cpu")
    if family == "sdxl":
        eng = TS.SDXLEngine(UNetConfig.tiny_xl(), VAEConfig.tiny(), TS.SDXLTextConfigs.tiny(), **kw)
    elif family == "sd3":
        eng = SD3Engine(MMDiTConfig.tiny(), VAEConfig.tiny16(), TS.SDXLTextConfigs.tiny(), **kw)
    else:
        eng = TS.StableDiffusionEngine(UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                                       **kw)
    eng.load_state_dicts(sds[family])
    return eng

def run_case(name, inp, mesh):
    # -> (loss, {leaf: gradient}, {leaf: updated value}, the step's loss,
    #     the number of parameters the trained module holds a slice of)
    c = inp[name]
    eng = engine(c["family"], inp["sds"])
    if name == "controlnet":
        eng.init_controlnet(0).load_state_dict(c["controlnet"])
    if mesh is not None:
        eng.parallelize(mesh)
    rows = batch_sharding(mesh).take
    lat, ctx = rows(c["lat"]), rows(c["ctx"])
    if name == "distill":
        tr = LCMDistiller(eng, LCMDistillConfig(**c["cfg"]), mesh=mesh)
        st = tr.init_state(trainable=c.get("trainable"))
        args = (st, lat, ctx, rows(c["uncond"]))
        kw = dict(idx=c["idx"], noise=c["noise"])
        loss, grads = tr.value_and_grad(*args, **kw)
        st, m = tr.distill_step(*args, **kw)
    else:
        tr = DiffusionTrainer(eng, TrainConfig(**c["cfg"]), mesh=mesh)
        st = tr.init_state(adapters=c.get("adapters"))
        kw = {k: c[k] for k in ("noise", "timesteps", "u") if k in c}
        for k in ("hint", "added"):
            if k in c:
                kw[k] = rows(c[k]) if k == "hint" else {a: rows(v) for a, v in c[k].items()}
        loss, grads = tr.value_and_grad(st, lat, ctx, **kw)
        st, m = tr.train_step(st, lat, ctx, **kw)
    new = {k: v.detach().clone() for k, v in leaves(st.trainable).items()}
    cut = len(getattr(eng.controlnet if name == "controlnet" else eng.unet, "tp_cuts", {}))
    return float(loss), {k: g.clone() for k, g in grads.items()}, new, float(m["loss"]), cut
"""

_RANKS = _CASES + """
from sonicdiffusionbayeslab_torch.parallel import mesh as M
from sonicdiffusionbayeslab_torch.parallel import distributed as D
mesh = M.make_mesh(n_data=ARGS["n_data"], n_model=2)
inp = torch.load(OUT + "/cases.pt", weights_only=False)
res = {"coords": [M.axis_index(mesh, "data"), M.axis_index(mesh, "model")]}
for name in ARGS["cases"]:
    res[name] = run_case(name, inp, mesh)
if ARGS["loop"]:
    from sonicdiffusionbayeslab_torch.config import ConfigNode, validate_config
    from sonicdiffusionbayeslab_torch.training.loop import run_training
    out = run_training(validate_config(ConfigNode(ARGS["loop"])))
    res["loop_losses"] = out["losses"]
    x = torch.ones(3, requires_grad=True)
    for what, fn in (("all_reduce_sum_", lambda: D.all_reduce_sum_(x * 1, mesh.get_group("model"))),
                     ("all_gather_seq", lambda: D.all_gather_seq(x * 1, 0, mesh.get_group("model"))),
                     ("halo_exchange", lambda: D.halo_exchange(x.view(1, 3) * 1, 1, 1,
                                                               mesh.get_group("model")))):
        try:
            fn()
        except RuntimeError as e:
            res[what] = str(e)
torch.save(res, OUT + f"/rank{R}.pt")
"""


def _rel_close(got, want, tol, what, floor=0.0):
    """max |got - want| within ``tol`` of want's largest magnitude (at
    least ``floor``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    top = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * top, f"{what}: max |diff| {err:.3g} > {tol} x {top:.3g}"


def _perturbed_b(adapters, seed=4):
    """JAX adapters with a random b (0 at init), so that every a learns."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        if p[-1].key == "b" else v, np_tree(adapters))


def _state_dicts(teng):
    return {m: mod.state_dict() for m, mod in zip(teng.MODULES, teng.modules())}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The cases' weights (the JAX engines' random ones), initial
    trainables (JAX's, b perturbed; a random ControlNet) and draws; one
    process's step of every case; the JAX trainer's (and distiller's)
    loss and gradients of every case."""
    jeng, params, teng = tiny_engines()
    xeng, xparams, xteng = tiny_family_engines("sdxl")
    seng, sparams, steng = tiny_sd3_engines()
    lat, ctx = randn((2, 8, 8, 4), 1), randn((2, 77, 32), 2)
    tsteps, noise = jax_draws(0, lat.shape)
    key = jax.random.PRNGKey(3)
    lora = _perturbed_b(JL.init_lora(params["unet"], 4, key))
    xlora = _perturbed_b(JL.init_lora(xparams["unet"], 4, key))
    slora = _perturbed_b(JL.init_lora(sparams["unet"], 4, key, JL.MMDIT_TARGETS))
    distill_cfg = dict(lora_rank=4, original_inference_steps=10)
    jdist = JD.LCMDistiller(jeng, JD.LCMDistillConfig(donate=False, **distill_cfg))
    dlora = _perturbed_b(jdist.init_state(params, key=key).trainable)
    cn_sd = _controlnet_state()
    cn = _jax_tree(cn_sd, W.controlnet_name_map(UNetConfig.tiny()))
    draws = dict(noise=torch.from_numpy(noise), timesteps=torch.from_numpy(tsteps))
    tl, tc = torch.from_numpy(lat), torch.from_numpy(ctx)
    gen = torch.Generator().manual_seed(5)
    cases = {
        "sds": {"sd15": _state_dicts(teng), "sdxl": _state_dicts(xteng),
                "sd3": _state_dicts(steng)},
        "lora": dict(family="sd15", lat=tl, ctx=tc, **draws,
                     adapters=W.lora_from_jax(lora, UNetConfig.tiny()),
                     cfg=dict(lora_rank=4, snr_gamma=5.0, learning_rate=LR["lora"])),
        "full_remat": dict(family="sd15", lat=tl, ctx=tc, **draws,
                           cfg=dict(remat=True, learning_rate=LR["full_remat"])),
        "controlnet": dict(family="sd15", lat=tl, ctx=tc, **draws,
                           controlnet=cn_sd,
                           hint=torch.rand(2, 64, 64, 3, generator=gen),
                           cfg=dict(train_target="controlnet",
                                    learning_rate=LR["controlnet"])),
        "distill": dict(family="sd15", lat=tl, ctx=tc, uncond=torch.from_numpy(randn(
            (2, 77, 32), 6)), idx=torch.tensor([3, 7]), noise=draws["noise"],
            trainable=W.trainable_from_jax(dlora, UNetConfig.tiny()),
            cfg=dict(**distill_cfg, learning_rate=LR["distill"])),
        "sdxl_lora": dict(family="sdxl", lat=tl, ctx=torch.from_numpy(randn((2, 77, 32), 7)),
                          adapters=W.lora_from_jax(xlora, UNetConfig.tiny_xl()), **draws,
                          added={"text_embeds": torch.from_numpy(randn((2, 16), 8)),
                                 "time_ids": torch.tensor([[16.0, 16, 0, 0, 16, 16]] * 2)},
                          cfg=dict(lora_rank=4, learning_rate=LR["sdxl_lora"])),
        "sd3_lora": dict(family="sd3", lat=torch.from_numpy(randn((2, 8, 8, 16), 9)),
                         ctx=torch.from_numpy(randn((2, 7, 40), 10)), noise=torch.from_numpy(
                             randn((2, 8, 8, 16), 11)), u=torch.from_numpy(randn((2,), 12)),
                         adapters=W.mmdit_lora_from_jax(slora),
                         added={"text_embeds": torch.from_numpy(randn((2, 32), 13))},
                         cfg=dict(objective="flow", lora_rank=4, learning_rate=LR["sd3_lora"],
                                  lora_targets=r".*\.(to_q|to_k|to_v|to_out\.0|add_q_proj|"
                                               r"add_k_proj|add_v_proj|to_add_out)\.weight$")),
    }
    root = tmp_path_factory.mktemp("split_train")
    torch.save(cases, root / "cases.pt")
    scope = {}
    exec(_CASES, scope)
    one = {name: scope["run_case"](name, cases, None) for name in CASES}
    # The JAX side of every case on the same weights, trainables, latents and draws.
    j = lambda a: jnp.asarray(np.asarray(a))  # noqa: E731
    c = cases["distill"]
    vg = _jax_distill_loss(jdist, params, j(lat), j(ctx), j(c["uncond"]), j(c["idx"]),
                           j(noise), jnp.full((2,), jdist.config.guidance_scale))
    tree = jax.tree.map(jnp.asarray, dlora)
    dl, dg = vg(tree, tree)
    jax_side = {"distill": (float(dl), leaves(W.trainable_from_jax(np_tree(dg),
                                                                   UNetConfig.tiny())))}
    for name, eng, p, tree, names in (
            ("lora", jeng, params, lora,
             lambda g: leaves(W.lora_from_jax(g, UNetConfig.tiny()))),
            ("full_remat", jeng, params, params["unet"],
             lambda g: W.invert(g, W.unet_name_map(UNetConfig.tiny()))),
            ("controlnet", jeng, params, cn,
             lambda g: W.invert(g, W.controlnet_name_map(UNetConfig.tiny()))),
            ("sdxl_lora", xeng, xparams, xlora,
             lambda g: leaves(W.lora_from_jax(g, UNetConfig.tiny_xl()))),
            ("sd3_lora", seng, sparams, slora, lambda g: leaves(W.mmdit_lora_from_jax(g)))):
        c = cases[name]
        jcfg = JT.TrainConfig(**{k: v for k, v in c["cfg"].items() if k != "lora_targets"})
        loss, grads = _jax_train_loss(eng, p, jcfg, c)(jax.tree.map(jnp.asarray, tree))
        jax_side[name] = (float(loss), {k: torch.from_numpy(np.asarray(v))
                                        for k, v in names(np_tree(grads)).items()})
    return dict(root=root, one=one, jax=jax_side)


def _controlnet_state():
    """A tiny ControlNet with random heads (``init_controlnet`` zeroes them,
    which would leave the encoder copy without a gradient)."""
    from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
    from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine
    from sonicdiffusionbayeslab_torch.models.vae import VAEConfig

    eng = StableDiffusionEngine(UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                                dtype=torch.float32, device="cpu")
    net = eng.init_controlnet(0)
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.abs().max() == 0:
                p.normal_(0.0, 0.05, generator=gen)
    return {k: v.clone() for k, v in net.state_dict().items()}


# W.invert's layout transforms, undone.
_UNDO = {W._conv: lambda w: np.transpose(w, (2, 3, 1, 0)), W._lin: np.transpose,
         W._dense_to_conv1x1: lambda w: np.transpose(w[:, :, 0, 0]), W._id: np.asarray}


def _jax_tree(sd, name_map):
    """The JAX tree that ``W.invert(tree, name_map)`` maps to the
    torch-layout state dict ``sd`` (every entry of ``sd``, bit for bit)."""
    tree = {}
    for path, (name, fwd) in name_map.items():
        if name not in sd:  # the map's entries for modules this network lacks
            continue
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = _UNDO[fwd](sd[name].numpy())
    back = W.invert(tree, {k: v for k, v in name_map.items() if v[0] in sd})
    assert set(back) == set(sd) and all(np.array_equal(back[k], sd[k].numpy()) for k in sd)
    return tree


def _jax_train_loss(jeng, params, cfg, c):
    """The JAX trainer's loss_fn (``training/trainer.py``: the noised
    latents and target of ``cfg.objective``, min-SNR weights, the
    ControlNet's residuals into the frozen UNet, LoRA applied to it) on
    case ``c``'s latents, context and draws, as a jitted value-and-grad of
    the trainable tree (adapters, the UNet's tree or the ControlNet's)."""
    a = lambda x: jnp.asarray(np.asarray(x))  # noqa: E731
    lat, ctx, noise = a(c["lat"]), a(c["ctx"]), a(c["noise"])
    B = lat.shape[0]
    w = jnp.ones((B,), jnp.float32)
    if cfg.objective == "flow":
        sigma = jax.nn.sigmoid(cfg.logit_mean + cfg.logit_std * a(c["u"]))
        s = sigma[:, None, None, None]
        noisy, y, t = (1.0 - s) * lat + s * noise, noise - lat, sigma * cfg.flow_num_train_timesteps
    else:
        ac = jnp.asarray(JT.DiffusionTrainer(jeng, cfg).schedule.alphas_cumprod, jnp.float32)
        t = a(c["timesteps"])
        al = ac[t][:, None, None, None]
        noisy, y = jnp.sqrt(al) * lat + jnp.sqrt(1.0 - al) * noise, noise
        if cfg.snr_gamma is not None:
            snr = (ac / (1.0 - ac))[t]
            w = jnp.minimum(snr, cfg.snr_gamma) / snr
    added = ({k: a(v) for k, v in c["added"].items()},) if "added" in c else ()
    frozen, tt = params["unet"], t.astype(jnp.float32)
    unet = jeng.unet

    def loss(tree):
        if cfg.train_target == "controlnet":
            res = jeng.controlnet.apply({"params": tree}, noisy, tt, ctx, a(c["hint"]),
                                        cfg.controlnet_scale)
            pred = unet.apply({"params": frozen}, noisy, tt, ctx, control_residuals=res)
        else:
            p = JL.apply_lora(frozen, tree, scale=cfg.lora_scale) if cfg.lora_rank else tree
            pred = unet.apply({"params": p}, noisy, tt, ctx, *added)
        return jnp.mean(w * jnp.mean((pred.astype(jnp.float32) - y) ** 2, axis=(1, 2, 3)))

    return jax.jit(jax.value_and_grad(loss))


def _session(inputs, name, n, n_data, cases, loop):
    out = inputs["root"] / name
    out.mkdir()
    (out / "cases.pt").symlink_to(inputs["root"] / "cases.pt")
    run_ranks(_RANKS, out, {"n_data": n_data, "cases": list(cases), "loop": loop}, n=n,
              timeout=400)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def loop_config(tmp_path_factory):
    """A tiny LoRA run's config (its dataset of PNGs written here), as the
    ranks get it, and one process's run of it."""
    root = tmp_path_factory.mktemp("split_loop")
    raw = _config(root, {**LOOP, "save_dir": str(root / "one")}).to_dict()
    one = TLoop.run_training(validate_config(ConfigNode(raw)))
    raw["training"].update(save_dir=str(root / "split"), mesh_data=1, mesh_model=2)
    return dict(raw=raw, root=root, losses=one["losses"])


@pytest.fixture(scope="module")
def model2(inputs, loop_config):
    return _session(inputs, "model2", 2, 1, CASES, loop_config["raw"])


@pytest.fixture(scope="module")
def data2_model2(inputs):
    return _session(inputs, "data2model2", 4, 2, ("lora",), None)


def _step_close(got, want, name):
    loss, grads, new, step_loss, cut = got
    w_loss, w_grads, w_new, w_step_loss, w_cut = want
    assert cut > 0 and w_cut == 0  # the ranks ran split, one process whole
    np.testing.assert_allclose(loss, w_loss, rtol=1e-5)
    np.testing.assert_allclose(step_loss, w_step_loss, rtol=1e-5)
    assert set(grads) == set(w_grads) and len(grads) > 0
    # A tensor whose gradient is zero in exact arithmetic (a bias or time
    # projection before a GroupNorm of one channel a group) holds fp32
    # noise: its scale is taken as 1% of the case's largest gradient.
    floor = 1e-2 * max(float(g.abs().max()) for g in w_grads.values())
    for k, g in grads.items():
        _rel_close(g, w_grads[k], GRAD_TOL.get(name, 1e-5), f"{name} gradient {k}", floor)
        assert new[k].shape == w_new[k].shape
    keys = sorted(new)
    assert_adam_close(torch.cat([new[k].reshape(-1) for k in keys]),
                      torch.cat([w_new[k].reshape(-1) for k in keys]), step_lrs(LR[name], 1))
    moved = sum(int(g.abs().max() > 0) for g in grads.values())
    assert moved >= len(grads) // 3, f"{name}: {moved} of {len(grads)} gradients nonzero"


@pytest.mark.parametrize("name", CASES)
def test_step_on_the_model_axis_matches_one_process(model2, inputs, name):
    """One step of each case at ``mesh_model=2``: both ranks the same
    bits, and one process's loss, gradients and updated tensors."""
    r0, r1 = model2
    assert r0["coords"] == [0, 0] and r1["coords"] == [0, 1]
    for a, b in zip(r0[name][1].values(), r1[name][1].values()):
        assert torch.equal(a, b)
    _step_close(r0[name], inputs["one"][name], name)


def _jax_close(got, want, name):
    """A split step's loss and every trainable tensor's gradient within 2e-4
    of the JAX side's, of the tensor's largest magnitude (full fine-tuning
    and the ControlNet: or of a hundredth of the case's largest, as
    ``_step_close``, for their conv biases before a GroupNorm of one
    channel a group, whose gradients are fp32 noise about zero)."""
    loss, grads = got[:2]
    w_loss, w_grads = want
    np.testing.assert_allclose(loss, w_loss, rtol=2e-4)
    assert set(grads) == set(w_grads) and len(grads) > 0
    floor = (1e-2 * max(float(g.abs().max()) for g in w_grads.values())
             if name in ("full_remat", "controlnet") else 0.0)
    for k, g in grads.items():
        _rel_close(g, w_grads[k].numpy(), 2e-4, f"{name} gradient {k}", floor)


def test_lora_step_on_the_model_axis_matches_jax(model2, inputs):
    """The split LoRA step's loss and every adapter's gradient within 2e-4
    of the JAX trainer's on the same weights, adapters and draws."""
    _jax_close(model2[0]["lora"], inputs["jax"]["lora"], "lora")


@pytest.mark.parametrize("name", [c for c in CASES if c != "lora"])
def test_step_on_the_model_axis_matches_jax(model2, inputs, name):
    """Full fine-tuning, ControlNet, LCM-LoRA distillation, SDXL's LoRA and
    SD3's flow LoRA at ``mesh_model=2``: the loss and every trainable
    tensor's gradient within 2e-4 of the JAX trainer's (the distiller's)
    loss function on the same weights, trainables, latents and draws."""
    _jax_close(model2[0][name], inputs["jax"][name], name)


def test_data_and_model_four_ranks_match_one_process(data2_model2, inputs):
    """The LoRA step on four ranks, ``mesh_data: 2, mesh_model: 2``: each
    rank its row of the batch, the gradients summed over model and
    averaged over data, one process's step on every rank."""
    assert sorted(tuple(r["coords"]) for r in data2_model2) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in data2_model2:
        _step_close(r["lora"], inputs["one"]["lora"], "lora")


def test_run_training_mesh_model_saves_one_process_files(model2, loop_config):
    """``run_training`` at ``mesh_data: 1, mesh_model: 2``: rank 0 saves the
    whole adapters, one process's keys and shapes, Adam-close in value;
    the logged losses within 1e-5."""
    root = loop_config["root"]
    np.testing.assert_allclose(model2[0]["loop_losses"], loop_config["losses"], rtol=1e-5)
    got = np.load(root / "split" / "final" / "lora_peft.npz")
    want = np.load(root / "one" / "final" / "lora_peft.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape
        assert_adam_close(got[k], want[k], step_lrs(LOOP["learning_rate"], LOOP["num_steps"]))


def test_in_place_collectives_refuse_a_tensor_that_requires_grad(model2):
    """A gradient through the in-place collectives would be cut: under grad
    mode they raise, naming the differentiable ones."""
    for what in ("all_reduce_sum_", "all_gather_seq", "halo_exchange"):
        assert "all_reduce_sum and model_entry" in model2[0][what], what
