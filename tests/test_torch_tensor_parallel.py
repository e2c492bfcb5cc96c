"""Tensor- and sequence-parallel execution of the port (ROADMAP A9) on the
CPU: gloo ranks in subprocesses against one-process runs and the JAX
package.

Three groups of ranks, each started once: two ranks on the ``model`` axis, two
on ``seq`` and four on ``seq`` x ``model`` (``run_ranks`` of
``test_torch_parallel.py``, one torch thread a rank, tiny fp32 models).
Every rank holds its result against the one-process port run of the same
module or call within 1e-5 (layers: of the output's largest magnitude;
images: absolutely); the engine's images are also held within 2e-4 to the
JAX engine's on its 2 x 2 x 2 ("data", "seq", "model") mesh with the same
weights, initial latents and plan rows, as ``tests/test_weights_mesh.py``
holds its own meshes.  Int8 (every mode under ``model``, the conv modes
under ``seq``) is held to one process's int8 run within that run's own
drift from the exact one (the rule of ``tests/test_torch_quant.py``, which
holds that drift to the JAX engine's); Token Merging under ``seq`` within
1e-5 of one process (UNet and MMDiT) and 2e-4 of the JAX engine (UNet,
given the JAX UNet's destinations).  What stays refused is training under
``seq``, which the JAX loop has no mode for.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import REPO, _cli_overrides, _tsv, run_ranks
from torch_parity import jax_tome_destinations, randn, t, tiny_engines
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.ops import groupnorm as GN
from sonicdiffusionbayeslab_torch.parallel import distributed as D
from sonicdiffusionbayeslab_torch.parallel import mesh as M
from sonicdiffusionbayeslab_torch.registry import load_all_plugins, models_registry

PROMPTS = ["a cat", "a dog", "a boat", "a lighthouse"]
CALL = dict(num_inference_steps=3, guidance_scale=5.0, seed=7)
PIPE_KW = dict(pretrained_model="x", tiny=True, image_size=64, dtype="float32", device="cpu")
# smoke.yaml's model runs in bf16, where the split's other order of sums
# moves a tiny random model's images by up to ~0.09: the CLI runs in fp32.
CLI_FP32 = {"model.dtype": "float32"}

# The layers each group checks against the same module unsplit.
# The int8 cases (a row-parallel layer's scales all-maxed over model, its
# int32 partials summed; a conv's sample scale all-maxed over seq) hold
# the split to one process as the exact ones: their sums are exact.
# The fused cases: to_qkv and to_kv cut a section at a time (each rank its
# heads of q, of k and of v), with and without int8; under seq the fused
# self-attention's K/V gathered, and the CFG shared prefix's tile.
MODEL_LAYERS = ("attention_self", "attention_cross_ip", "attention_5_heads_unsplit", "geglu",
                "resnet_32_to_64", "resnet_64", "mmdit_block", "t5_block", "attention_self_int8",
                "geglu_int8", "resnet_64_int8_conv", "attention_self_fused",
                "attention_cross_fused_ip", "attention_self_fused_int8")
SEQ_LAYERS = ("conv_in", "resnet_32_to_64", "downsample", "upsample", "group_norm",
              "spatial_transformer", "spatial_transformer_int8", "mmdit_block",
              "downsample_int8_conv", "resnet_32_to_64_int8_conv", "spatial_transformer_fused",
              "spatial_transformer_cfg_tile")

_LAYERS = """
from sonicdiffusionbayeslab_torch.models import layers as L
from sonicdiffusionbayeslab_torch.models.mmdit import MMDiTBlock, MMDiTConfig
from sonicdiffusionbayeslab_torch.models.sampler import init_module
from sonicdiffusionbayeslab_torch.models.t5 import T5Block, T5Config
from sonicdiffusionbayeslab_torch.ops.quant import set_quant_mode
from sonicdiffusionbayeslab_torch.parallel import mesh as M

def rnd(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))

def layer_cases():
    # name -> (module, args, kwargs, dim of the height in the output or None)
    x4 = rnd((2, 8, 8, 32), 1)
    tokens = rnd((2, 16, 32), 2)
    ctx = rnd((2, 5, 24), 3)
    temb = rnd((2, 128), 4)
    mm = MMDiTConfig(depth=1, num_heads=2, head_dim=16, joint_attention_dim=32)
    cross = L.Attention(32, 2, 16, context_dim=24)
    cross.add_ip()
    cross_f = L.Attention(32, 2, 16, context_dim=24, fused_qkv=True)
    cross_f.add_ip()
    st = L.SpatialTransformer(32, 2, 16, 24)
    st8 = set_quant_mode(L.SpatialTransformer(32, 2, 16, 24), "int8")
    q = set_quant_mode
    return {
        "attention_self": (L.Attention(32, 2, 16), (tokens,), {}, None),
        "attention_cross_ip": (cross, (tokens, ctx), dict(ip_context=rnd((2, 4, 24), 5),
                                                          ip_scale=torch.tensor(0.7)), None),
        "attention_5_heads_unsplit": (L.Attention(40, 5, 8), (rnd((2, 16, 40), 6),), {}, None),
        "geglu": (L.GEGLUFeedForward(32), (tokens,), {}, None),
        "resnet_32_to_64": (L.ResnetBlock(32, 64, 128), (x4, temb), {}, 1),
        "resnet_64": (L.ResnetBlock(64, 64, 128), (rnd((2, 8, 8, 64), 7), temb), {}, 1),
        "conv_in": (torch.nn.Conv2d(4, 32, 3, padding=1), (rnd((2, 8, 8, 4), 8),), {}, 1),
        "downsample": (L.Downsample(32, allow_quant=True), (x4,), {}, 1),
        "upsample": (L.Upsample(32, allow_quant=True), (x4,), {}, 1),
        "group_norm": (L.GroupNorm(64, silu=True), (rnd((2, 8, 8, 64), 9),), {}, 1),
        "spatial_transformer": (st, (x4, ctx), {}, 1),
        "spatial_transformer_int8": (st8, (x4, ctx), {}, 1),
        "mmdit_block": (MMDiTBlock(mm), (rnd((2, 16, 32), 10), rnd((2, 5, 32), 11),
                                         rnd((2, 32), 12)), {}, 1),
        "t5_block": (T5Block(T5Config.tiny(), True), (rnd((2, 6, 40), 13),
                                                       rnd((1, 2, 6, 6), 14)), {}, None),
        "attention_self_int8": (q(L.Attention(32, 2, 16), "int8"), (tokens,), {}, None),
        "geglu_int8": (q(L.GEGLUFeedForward(32), "int8"), (tokens,), {}, None),
        "resnet_64_int8_conv": (q(L.ResnetBlock(64, 64, 128), "int8_conv"),
                                (rnd((2, 8, 8, 64), 7), temb), {}, 1),
        "downsample_int8_conv": (q(L.Downsample(32, allow_quant=True), "int8_conv"), (x4,), {},
                                 1),
        "resnet_32_to_64_int8_conv": (q(L.ResnetBlock(32, 64, 128), "int8_conv"), (x4, temb),
                                      {}, 1),
        "attention_self_fused": (L.Attention(32, 2, 16, fused_qkv=True), (tokens,), {}, None),
        "attention_cross_fused_ip": (cross_f, (tokens, ctx), dict(ip_context=rnd((2, 4, 24), 5),
                                                                  ip_scale=torch.tensor(0.7)),
                                     None),
        "attention_self_fused_int8": (q(L.Attention(32, 2, 16, fused_qkv=True), "int8"),
                                      (tokens,), {}, None),
        "spatial_transformer_fused": (L.SpatialTransformer(32, 2, 16, 24, fused_qkv=True),
                                      (x4, ctx), {}, 1),
        "spatial_transformer_cfg_tile": (L.SpatialTransformer(32, 2, 16, 24),
                                         (x4, torch.cat([ctx, ctx.flip(0)])),
                                         dict(cfg_tile=True), 1),
    }

def run_layers(names, ctx, rows):
    errs = {}
    cases = layer_cases()
    for i, name in enumerate(names):
        module, args, kw, hdim = cases[name]
        init_module(module, torch.Generator().manual_seed(i))
        with torch.no_grad():  # biases and norm scales away from 0 and 1
            for p in module.parameters():
                if p.dim() == 1:
                    p.normal_(0.0, 0.5, generator=torch.Generator().manual_seed(100 + i))
        call = module
        if name == "conv_in":  # a bare conv, as the UNet's conv_in runs
            call = lambda x: L.seq_conv(module, x, getattr(module, "par", None))
        with torch.no_grad():
            want = call(*args, **kw)
        plan = M.place_module(module, ctx)
        if rows is not None and hdim is not None:
            # this rank's rows of the map; an MMDiT block's 4 x 4 image
            # tokens: 4 tokens a latent row pair (patch 2), so 2 a row
            a = args[0]
            cut = a[:, 2 * rows.start:2 * rows.stop] if name == "mmdit_block" else None
            args = (args[0][:, rows] if cut is None else cut,) + args[1:]
        if name == "t5_block" and ctx.n_model > 1:  # the bias of the rank's heads
            h = args[1].shape[1] // ctx.n_model
            args = (args[0], args[1][:, ctx.model_index * h:(ctx.model_index + 1) * h])
        with torch.no_grad():
            got = call(*args, **kw)
        if isinstance(want, tuple):
            want, got = want[0], got[0]
        if rows is not None and hdim is not None:
            k = want.shape[hdim] // ctx.n_seq
            want = want.narrow(hdim, ctx.seq_index * k, k)
        errs[name] = dict(err=float((got - want).abs().max()), top=float(want.abs().max()),
                          split=sorted(k for k, d in plan.items() if d is not None),
                          shape=list(got.shape))
    return errs
"""

_ENGINE = """
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine
from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
from sonicdiffusionbayeslab_torch.models.vae import VAEConfig

def engine_runs(mesh, res, arrays):
    eng = StableDiffusionEngine(UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                                dtype=torch.float32, device="cpu")
    eng.load_state_dicts(torch.load(OUT + "/sds.pt"))
    res["plans"] = {k: sorted(n for n, d in v.items() if d is not None)
                    for k, v in eng.parallelize(mesh).items()}
    inp = np.load(OUT + "/inputs.npz")
    emb, neg = torch.from_numpy(inp["emb"]), torch.from_numpy(inp["neg"])
    plan = S.DPMSolverScheduler(solver_order=2).build_plan(3)
    out = eng.sample(plan, emb, neg, guidance_scale=7.5, latent_hw=(8, 8),
                     init_latents=inp["lat0"], collect_x0=True, x0_samples=3, mesh=mesh)
    arrays.update(engine=out.images.numpy(), engine_latents=out.latents.numpy(),
                  engine_x0=out.x0_images.numpy())
    lcm = S.LCMScheduler().build_plan(3)
    arrays["lcm_rescale"] = eng.sample(lcm, emb, neg, seed=3, guidance_scale=4.0,
                                       guidance_rescale=0.7, latent_hw=(8, 8),
                                       sample_indices=np.arange(10, 14), mesh=mesh).images.numpy()
    arrays["cfg_prefix"] = eng.sample(plan, emb, neg, guidance_scale=7.5, latent_hw=(8, 8),
                                      init_latents=inp["lat0"], mesh=mesh,
                                      cfg_prefix=True).images.numpy()
    return eng, plan, emb, neg

def int8_runs(eng, plan, emb, neg, modes, mesh, arrays):
    inp = np.load(OUT + "/inputs.npz")
    for mode in modes:
        eng.set_quant_mode(mode)
        arrays["int8:" + mode] = eng.sample(plan, emb, neg, guidance_scale=7.5, latent_hw=(8, 8),
                                            init_latents=inp["lat0"], mesh=mesh).images.numpy()
    eng.set_quant_mode(None)

def tome_run(eng, plan, emb, neg, mesh):
    inp = np.load(OUT + "/inputs.npz")
    return eng.sample(plan, emb, neg, guidance_scale=7.5, latent_hw=(8, 8),
                      init_latents=inp["lat0"], tome=0.5, tome_dst=inp["tome_dst"],
                      mesh=mesh).images.numpy()
"""

_MODEL = _LAYERS + _ENGINE + """
import os
from sonicdiffusionbayeslab_torch import cli
from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
from sonicdiffusionbayeslab_torch.registry import load_all_plugins, models_registry
from sonicdiffusionbayeslab_torch.serving import GenerateRequest, InferenceServer, follow
load_all_plugins()
mesh = M.make_mesh(n_data=1, n_model=2)
ctx = M.ParallelContext.from_mesh(mesh)
res, arrays = {}, {}
res["layers"] = run_layers(ARGS["layers"], ctx, None)
eng, plan, emb, neg = engine_runs(mesh, res, arrays)
int8_runs(eng, plan, emb, neg, ("int8", "int8_conv", "int8_conv_only"), mesh, arrays)
# The fused UNet (to_qkv, to_kv) from the same weights, split a section at a time.
from sonicdiffusionbayeslab_torch.models.weights import fuse_projections
fused = StableDiffusionEngine(UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                              dtype=torch.float32, device="cpu", fused_qkv=True)
fused.load_state_dicts({k: fuse_projections(v, getattr(fused, k))
                        for k, v in torch.load(OUT + "/sds.pt").items()})
res["fused_plan"] = sorted(k for k, d in fused.parallelize(mesh)["unet"].items()
                           if d is not None and k.endswith(("to_qkv.weight", "to_kv.weight")))
arrays["fused"] = fused.sample(plan, emb, neg, guidance_scale=7.5, latent_hw=(8, 8),
                               init_latents=np.load(OUT + "/inputs.npz")["lat0"],
                               mesh=mesh).images.numpy()
del fused
for key, (name, extra, args) in ARGS["pipelines"].items():
    p = models_registry[name](**ARGS["pipe_kw"], mesh_model=2, **extra)
    if name.startswith("stable_diffusion_3"):
        p.scheduler = S.FlowMatchEulerScheduler()
    res[key + ":placements"] = {m: sorted(k for k, v in pl.items() if "Shard" in str(v))
                                for m, pl in p.placements.items()}
    a = {k: (np.asarray(v, np.float32) if isinstance(v, list) else v) for k, v in args.items()}
    arrays[key] = p(ARGS["prompts"], **ARGS["call"], **a)[0]
del p
os.chdir(OUT + f"/cwd{R}")
res["cli"] = cli.run(ARGS["config"], ARGS["overrides"], device="cpu")
pipe = StableDiffusionModel(**ARGS["pipe_kw"], mesh_model=2)
pipe.scheduler = S.DPMSolverScheduler(solver_order=2)
if R == 0:
    srv = InferenceServer(pipe, max_batch=1, max_wait_ms=10.0, readback_dtype="float32")
    try:
        served = srv.submit(GenerateRequest("a served lighthouse", num_inference_steps=3,
                                            seed=100)).result(timeout=180)
    finally:
        srv.shutdown()
    arrays["served"] = served["image"]
else:
    res["follower_calls"] = follow(pipe)
# A LoRA fused into the split UNet: each rank's slices of one process's fused weights.
from sonicdiffusionbayeslab_torch.models.weights import load_torch_state_dict, merge_lora
whole = StableDiffusionModel(**ARGS["pipe_kw"]).engine.unet.state_dict()
pipe.load_lora_weights(OUT + "/lora.bin").fuse_lora()
split = M.SplitParams.of(pipe.engine.unet)
fused, names = merge_lora(whole, load_torch_state_dict(OUT + "/lora.bin"))
local = pipe.engine.unet.state_dict()
res["fuse"] = dict(modules=len(names), cut=sum(f"{m}.weight" in split.cuts for m in names),
                   bad=[k for k, v in fused.items() if not torch.equal(split.local(k, v), local[k])],
                   changed=sum(not torch.equal(whole[k], fused[k]) for k in fused))
np.savez(OUT + f"/rank{R}.npz", **arrays)
json.dump(res, open(OUT + f"/rank{R}.json", "w"))
"""

_SEQ = _LAYERS + _ENGINE + """
from sonicdiffusionbayeslab_torch.parallel import distributed as D
from sonicdiffusionbayeslab_torch.registry import load_all_plugins, models_registry
load_all_plugins()
mesh = M.make_mesh(n_data=1, n_seq=2)
ctx = M.ParallelContext.from_mesh(mesh)
res, arrays = {}, {}
# The collectives on the seq group: rows of rank r are 10 r + (0, 1, 2).
x = (10.0 * R + torch.arange(3.0)).view(1, 3, 1, 1)
res["halo"] = D.halo_exchange(x, 1, 2, ctx.seq_group).flatten().tolist()
res["gathered"] = D.all_gather_seq(x, 1, ctx.seq_group).flatten().tolist()
res["summed"] = D.all_reduce_sum_(torch.full((2,), R + 1.0), ctx.seq_group).tolist()
only0 = torch.distributed.new_group([0])
if R == 1:
    try:
        D.halo_exchange(x, 1, 1, only0)
    except ValueError as e:
        res["foreign_group"] = str(e)
rows = M.latent_sharding(mesh, 2).height.rows(8)
res["layers"] = run_layers(ARGS["layers"], ctx, rows)
eng, plan, emb, neg = engine_runs(mesh, res, arrays)
int8_runs(eng, plan, emb, neg, ("int8_conv", "int8_conv_only"), mesh, arrays)
arrays["tome"] = tome_run(eng, plan, emb, neg, mesh)
try:
    eng.sample(plan, emb, neg, latent_hw=(6, 8), mesh=mesh)
except ValueError as e:
    res["odd_height"] = str(e)
for key, (name, extra, args) in ARGS["pipelines"].items():
    p = models_registry[name](**ARGS["pipe_kw"], mesh_seq=2, **extra)
    if name.startswith("stable_diffusion_3"):
        p.scheduler = S.FlowMatchEulerScheduler()
    a = {k: (np.asarray(v, np.float32) if isinstance(v, list) else v) for k, v in args.items()}
    arrays[key] = p(ARGS["prompts"], **ARGS["call"], **a)[0]
np.savez(OUT + f"/rank{R}.npz", **arrays)
json.dump(res, open(OUT + f"/rank{R}.json", "w"))
"""

_FOUR = _ENGINE + """
from sonicdiffusionbayeslab_torch.parallel import mesh as M
mesh = M.make_mesh(n_data=1, n_seq=2, n_model=2)
res, arrays = {}, {}
engine_runs(mesh, res, arrays)
res["coords"] = [M.axis_index(mesh, "seq"), M.axis_index(mesh, "model")]
np.savez(OUT + f"/rank{R}.npz", **arrays)
json.dump(res, open(OUT + f"/rank{R}.json", "w"))
"""


def _model_pipelines():
    rng = np.random.default_rng(3)
    return {
        "sd15": ("stable_diffusion_model", {}, {}),
        "sdxl": ("stable_diffusion_xl_model", {}, {}),
        "controlnet_ip": ("stable_diffusion_controlnet_model", {"ip_adapter": "missing.bin"},
                          {"control_image": rng.random((4, 64, 64, 3)).tolist(),
                           "ip_image_embeds": rng.standard_normal((4, 1024)).tolist()}),
        "sd3_t5": ("stable_diffusion_3_model", {"use_t5": True}, {}),
    }


def _seq_pipelines():
    rng = np.random.default_rng(4)
    return {
        "sd15_inpaint": ("stable_diffusion_model", {},
                         {"init_image": rng.random((4, 16, 16, 3)).tolist(),
                          "mask_image": (rng.random((4, 16, 16)) > 0.5).astype(
                              np.float32).tolist(), "strength": 0.7}),
        "controlnet": ("stable_diffusion_controlnet_model", {},
                       {"control_image": rng.random((4, 64, 64, 3)).tolist()}),
        "sd3_t5": ("stable_diffusion_3_model", {"use_t5": True}, {}),
        "sd3_tome": ("stable_diffusion_3_model", {}, {"tome_ratio": 0.5}),
    }


def _one_pipeline(name, extra, args):
    load_all_plugins()
    p = models_registry[name](**PIPE_KW, **extra)
    if name.startswith("stable_diffusion_3"):
        p.scheduler = S.FlowMatchEulerScheduler()
    arr = {k: (np.asarray(v, np.float32) if isinstance(v, list) else v) for k, v in args.items()}
    return p(PROMPTS, **CALL, **arr)[0]


@pytest.fixture(scope="module")
def engine_inputs(tmp_path_factory):
    """The tiny engines' weights, inputs, the one-process port run and the
    JAX engine's run on its 2 x 2 x 2 mesh."""
    from sonicdiffusionbayeslab_tpu import schedulers as JS
    from sonicdiffusionbayeslab_tpu.parallel import make_mesh as jax_make_mesh
    from sonicdiffusionbayeslab_tpu.parallel import shard_params as jax_shard_params

    from sonicdiffusionbayeslab_tpu.ops.tome import TomeConfig as JaxTomeConfig
    from sonicdiffusionbayeslab_torch.ops.tome import TomeConfig

    jeng, params, teng = tiny_engines()
    root = tmp_path_factory.mktemp("tp_inputs")
    plan = S.DPMSolverScheduler(solver_order=2).build_plan(3)
    inp = dict(emb=randn((4, 77, 32), 21), neg=randn((4, 77, 32), 22), lat0=randn((4, 8, 8, 4), 23),
               tome_dst=jax_tome_destinations(plan.timesteps,
                                              teng.unet.tome_slots(8, 8, TomeConfig(0.5))))
    np.savez(root / "inputs.npz", **inp)
    sds = {m: mod.state_dict() for m, mod in zip(teng.MODULES, teng.modules())}
    one = teng.sample(plan, t(inp["emb"]), t(inp["neg"]), guidance_scale=7.5, latent_hw=(8, 8),
                      init_latents=inp["lat0"], collect_x0=True, x0_samples=3)
    base = dict(guidance_scale=7.5, latent_hw=(8, 8), init_latents=inp["lat0"])
    one_more = {"tome": teng.sample(plan, t(inp["emb"]), t(inp["neg"]), tome=0.5,
                                    tome_dst=t(inp["tome_dst"]), **base).images.numpy()}
    for mode in ("int8", "int8_conv", "int8_conv_only"):
        teng.set_quant_mode(mode)
        one_more["int8:" + mode] = teng.sample(plan, t(inp["emb"]), t(inp["neg"]),
                                               **base).images.numpy()
    teng.set_quant_mode(None)
    lcm = S.LCMScheduler().build_plan(3)
    one_lcm = teng.sample(lcm, t(inp["emb"]), t(inp["neg"]), seed=3, guidance_scale=4.0,
                          guidance_rescale=0.7, latent_hw=(8, 8), sample_indices=np.arange(10, 14))
    mesh = jax_make_mesh(n_data=2, n_model=2, n_seq=2)
    jplan = JS.DPMSolverScheduler(solver_order=2).build_plan(3)
    with mesh:
        want = jeng.sample(jax_shard_params(params, mesh), jplan, jnp.asarray(inp["emb"]),
                           jnp.asarray(inp["neg"]), jax.random.PRNGKey(0), guidance_scale=7.5,
                           latent_hw=(8, 8), init_latents=jnp.asarray(inp["lat0"]), mesh=mesh)
    jax_tome = jeng.sample(params, jplan, jnp.asarray(inp["emb"]), jnp.asarray(inp["neg"]),
                           jax.random.PRNGKey(0), guidance_scale=7.5, latent_hw=(8, 8),
                           init_latents=jnp.asarray(inp["lat0"]), tome=JaxTomeConfig(0.5))
    return dict(sds=sds, inputs=inp, one={"engine": one.images.numpy(),
                                          "engine_latents": one.latents.numpy(),
                                          "engine_x0": one.x0_images.numpy(),
                                          "lcm_rescale": one_lcm.images.numpy(), **one_more},
                jax_images=np.asarray(want.images), jax_latents=np.asarray(want.latents),
                jax_tome=np.asarray(jax_tome.images))


def _ranks_run(tmp_path_factory, engine_inputs, name, body, n, args):
    out = tmp_path_factory.mktemp(name)
    _write_lora(out / "lora.bin", engine_inputs["sds"])
    np.savez(out / "inputs.npz", **engine_inputs["inputs"])
    torch.save(engine_inputs["sds"], out / "sds.pt")
    for r in range(n):
        (out / f"cwd{r}").mkdir()
    run_ranks(body, out, args, n=n, timeout=300)
    return out, [(dict(np.load(out / f"rank{r}.npz")),
                  json.loads((out / f"rank{r}.json").read_text())) for r in range(n)]


def _write_lora(path, sds, rank=4, seed=5):
    """A random peft-layout LoRA on every attention projection of the tiny UNet."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, w in sds["unet"].items():
        if k.endswith(".weight") and any(f".{p}.weight" in k for p in ("to_q", "to_k", "to_v")):
            m = k[: -len(".weight")]
            sd[f"unet.{m}.lora_A.weight"] = torch.randn(rank, w.shape[1], generator=g)
            sd[f"unet.{m}.lora_B.weight"] = 0.1 * torch.randn(w.shape[0], rank, generator=g)
            sd[f"unet.{m}.alpha"] = torch.tensor(float(rank))
    torch.save(sd, path)


@pytest.fixture(scope="module")
def model_run(tmp_path_factory, engine_inputs):
    args = {"layers": MODEL_LAYERS, "pipelines": _model_pipelines(), "prompts": PROMPTS,
            "call": CALL, "pipe_kw": PIPE_KW, "config": str(REPO / "configs" / "smoke.yaml"),
            "overrides": {**_cli_overrides(), **CLI_FP32, "model.mesh_model": 2}}
    return _ranks_run(tmp_path_factory, engine_inputs, "model2", _MODEL, 2, args)


@pytest.fixture(scope="module")
def seq_run(tmp_path_factory, engine_inputs):
    args = {"layers": SEQ_LAYERS, "pipelines": _seq_pipelines(), "prompts": PROMPTS,
            "call": CALL, "pipe_kw": PIPE_KW}
    return _ranks_run(tmp_path_factory, engine_inputs, "seq2", _SEQ, 2, args)


@pytest.fixture(scope="module")
def four_run(tmp_path_factory, engine_inputs):
    return _ranks_run(tmp_path_factory, engine_inputs, "seq2model2", _FOUR, 4, {})


# ------------------------------------------------------------ layers
def _layer_close(ranks, name):
    for _, res in ranks:
        rec = res["layers"][name]
        assert rec["err"] <= 1e-5 * max(1.0, rec["top"]), (name, rec)
    return [res["layers"][name] for _, res in ranks]


@pytest.mark.parametrize("name", MODEL_LAYERS)
def test_layers_on_the_model_axis_match_one_process(model_run, name):
    """Each layer placed at n_model 2 (its share of heads, hidden units and
    channels, the partials summed) gives every rank the unsplit layer's
    output within 1e-5.  The 64-channel resnet runs norm2 on 32 local
    channels in 16 groups (``resolve_groups(32, 32)`` would give 32); an
    attention of 5 heads keeps its whole weights."""
    recs = _layer_close(model_run[1], name)
    split = recs[0]["split"]
    if name == "attention_5_heads_unsplit":
        assert split == []
    elif name == "attention_cross_ip":
        assert split == ["to_k.weight", "to_k_ip.weight", "to_out.0.weight", "to_q.weight",
                         "to_v.weight", "to_v_ip.weight"]
    elif name.startswith("geglu"):
        assert split == ["net.0.proj.bias", "net.0.proj.weight", "net.2.weight"]
    elif name.startswith("resnet"):
        assert split == ["conv1.bias", "conv1.weight", "conv2.weight", "norm2.bias",
                         "norm2.weight"]
    else:
        assert split


@pytest.mark.parametrize("name", SEQ_LAYERS)
def test_layers_on_the_seq_axis_match_one_process(seq_run, name):
    """Each layer on its rank's rows of the height at n_seq 2 (halo rows for
    the 3x3 convs, Downsample's row above, Upsample's rows before the
    resize, GroupNorm's statistics merged by the split pair, K and V
    gathered for self-attention, int8 projections, whose activation scales
    are a token's) gives the unsplit layer's rows within 1e-5."""
    recs = _layer_close(seq_run[1], name)
    assert recs[0]["split"] == []  # nothing is cut on the seq axis


def test_seq_collectives_in_rank_order(seq_run):
    """halo_exchange: the rank above's last row and the rank below's first
    two, zeros at the image's edges; all_gather_seq in rank order;
    all_reduce_sum_ the same sum on every rank; a group this rank is not
    in raises."""
    (_, r0), (_, r1) = seq_run[1]
    assert r0["halo"] == [0.0, 0.0, 1.0, 2.0, 10.0, 11.0]
    assert r1["halo"] == [2.0, 10.0, 11.0, 12.0, 0.0, 0.0]
    assert r0["gathered"] == r1["gathered"] == [0.0, 1.0, 2.0, 10.0, 11.0, 12.0]
    assert r0["summed"] == r1["summed"] == [3.0, 3.0]
    assert "rank 1 is not a member of the group" in r1["foreign_group"]


def test_collectives_raise_without_a_process_group():
    x = torch.zeros(1, 2, 1, 1)
    for call in (lambda: D.all_reduce_sum_(x, None), lambda: D.all_gather_seq(x, 1, None),
                 lambda: D.halo_exchange(x, 1, 1, None)):
        with pytest.raises(RuntimeError, match="no process group"):
            call()


def test_split_group_norm_plain_pair_matches_group_norm():
    """The split pair's plain versions: partials of 2 and 4 row slices,
    gathered in order, merged and applied, give ``plain_group_norm``
    within 1e-5; the merged statistics within 1e-6 relative of one
    slice's."""
    x = torch.from_numpy(randn((2, 16, 8, 64), 31, 3.0) + 1.5)
    w, b = torch.from_numpy(randn((64,), 32)), torch.from_numpy(randn((64,), 33))
    want = GN.plain_group_norm(x, w, b, 16, 1e-5, True)
    whole = GN.merge_group_stats(GN.plain_group_norm_partials(x, 16)[None], 1e-5)
    for n in (2, 4):
        parts = torch.stack([GN.plain_group_norm_partials(s, 16) for s in x.chunk(n, dim=1)])
        stats = GN.merge_group_stats(parts, 1e-5)
        torch.testing.assert_close(stats, whole, rtol=1e-6, atol=0.0)
        got = torch.cat([GN.plain_group_norm_apply(s, parts, w, b, 1e-5, True)
                         for s in x.chunk(n, dim=1)], dim=1)
        torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)


# ------------------------------------------------------------ engine
def _engine_close(ranks, engine_inputs):
    one = engine_inputs["one"]
    for arrays, _ in ranks:
        for k in ("engine", "engine_x0", "lcm_rescale"):
            np.testing.assert_allclose(arrays[k], one[k], atol=1e-5, err_msg=k)
        top = float(np.abs(one["engine_latents"]).max())
        np.testing.assert_allclose(arrays["engine_latents"], one["engine_latents"],
                                   atol=1e-5 * top)
        np.testing.assert_allclose(arrays["engine"], engine_inputs["jax_images"], atol=2e-4)
        jl = engine_inputs["jax_latents"]
        np.testing.assert_allclose(arrays["engine_latents"], jl,
                                   atol=2e-4 * float(np.abs(jl).max()))
    for arrays, _ in ranks:  # the CFG shared prefix: the same math
        np.testing.assert_allclose(arrays["cfg_prefix"], one["engine"], atol=1e-5)
    first = ranks[0][0]
    for arrays, _ in ranks[1:]:
        for k, v in first.items():
            if k.startswith("engine") or k in ("lcm_rescale", "cfg_prefix"):
                assert np.array_equal(arrays[k], v), k


def _int8_close(ranks, engine_inputs, modes):
    """Each int8 mode's split images: the same on every rank, nearer one
    process's int8 run than that run is to the exact one, and nearer it
    than the exact run (relative L2; a split that ran exact would sit
    ~1e-6 from the exact run).  Not closer: a sampled image moves with
    every rounding the quantizer flips, and one process's own int8 run
    moves ~1e-2 for initial latents moved 1e-7, so the split's other
    order of fp32 sums elsewhere moves it as much; the split layers
    themselves are held to 1e-5 (the ``*_int8*`` layer cases)."""
    one = engine_inputs["one"]
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    for mode in modes:
        got = ranks[0][0]["int8:" + mode]
        for arrays, _ in ranks[1:]:
            assert np.array_equal(arrays["int8:" + mode], got), mode
        drift = rel(one["int8:" + mode], one["engine"])
        to_int8, to_exact = rel(got, one["int8:" + mode]), rel(got, one["engine"])
        assert 0.0 < drift and to_int8 < drift and to_int8 < to_exact, (mode, to_int8, drift,
                                                                       to_exact)


def test_sampled_int8_images_move_with_any_reordering(engine_inputs):
    """Why ``_int8_close`` holds the split int8 images to one process's no
    closer than the quantizer allows: initial latents moved 1e-7 (a
    relative perturbation, as another order of fp32 sums gives) move one
    process's exact images less than 1e-5 (relative L2) and its int8
    images more than 1e-3 in every mode, as each flipped rounding
    cascades.  The split int8 layers are held at 1e-5 instead."""
    teng = tiny_engines()[2]
    inp, one = engine_inputs["inputs"], engine_inputs["one"]
    lat = (inp["lat0"] * (1.0 + 1e-7 * randn(inp["lat0"].shape, 5))).astype(np.float32)
    plan = S.DPMSolverScheduler(solver_order=2).build_plan(3)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    moved = {}
    for mode, key in ((None, "engine"), ("int8", "int8:int8"), ("int8_conv", "int8:int8_conv"),
                      ("int8_conv_only", "int8:int8_conv_only")):
        teng.set_quant_mode(mode)
        try:
            got = teng.sample(plan, t(inp["emb"]), t(inp["neg"]), guidance_scale=7.5,
                              latent_hw=(8, 8), init_latents=lat).images.numpy()
        finally:
            teng.set_quant_mode(None)
        moved[mode] = rel(got, one[key])
    assert moved.pop(None) < 1e-5 and min(moved.values()) > 1e-3, moved


def test_engine_on_the_model_axis_matches_one_process_and_jax(model_run, engine_inputs):
    """engine.sample at n_model 2 (DPM++ with x0 decodes; LCM's step noise
    with rescaled CFG): every rank the same images, within 1e-5 of one
    process and 2e-4 of the JAX engine on its 2 x 2 x 2 mesh; int8, int8_conv
    and int8_conv_only (the row-parallel layers' scales all-maxed over the
    axis, their int32 partials summed) within one process's int8 drift."""
    ranks = model_run[1]
    _engine_close(ranks, engine_inputs)
    _int8_close(ranks, engine_inputs, ("int8", "int8_conv", "int8_conv_only"))
    res = ranks[0][1]
    split = res["plans"]["unet"]
    assert "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight" in split
    assert not any(k.startswith("time_embedding") for k in split)


def test_fused_engine_on_the_model_axis_matches_one_process(model_run, engine_inputs):
    """A UNet built with fused q/k/v projections (``to_qkv``, ``to_kv``; the
    weights concatenated by ``weights.fuse_projections``) at n_model 2:
    every fused weight cut a section at a time, the images the same on
    every rank and within 1e-5 of one process's separate projections."""
    ranks = model_run[1]
    for arrays, res in ranks:
        np.testing.assert_allclose(arrays["fused"], engine_inputs["one"]["engine"], atol=1e-5)
        assert np.array_equal(arrays["fused"], ranks[0][0]["fused"])
    cut = ranks[0][1]["fused_plan"]
    assert "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_qkv.weight" in cut
    assert "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_kv.weight" in cut


def test_engine_on_the_seq_axis_matches_one_process_and_jax(seq_run, engine_inputs):
    """engine.sample at n_seq 2 (each rank 4 of the 8 latent rows): the same
    gates; nothing is cut on the seq axis; the int8 conv modes (a sample's
    scale all-maxed over the axis) within one process's int8 drift; ToMe
    0.5 (each block's tokens gathered, the match over the whole map) within
    1e-5 of one process and 2e-4 of the JAX engine with the JAX UNet's
    destinations; a height whose shares do not divide by the UNet's
    downsampling raises ValueError."""
    ranks = seq_run[1]
    _engine_close(ranks, engine_inputs)
    _int8_close(ranks, engine_inputs, ("int8_conv", "int8_conv_only"))
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["tome"], engine_inputs["one"]["tome"], atol=1e-5)
        np.testing.assert_allclose(arrays["tome"], engine_inputs["jax_tome"], atol=2e-4)
    res = ranks[0][1]
    assert res["plans"]["unet"] == []
    assert "latent height 6 not divisible by seq axis 2 x 2" in res["odd_height"]


def test_engine_on_seq_and_model_four_ranks_matches_one_process_and_jax(four_run,
                                                                         engine_inputs):
    """Four ranks at n_seq 2 x n_model 2: the same gates, every rank the same
    images, against the JAX engine's 2 x 2 x 2 mesh."""
    ranks = four_run[1]
    _engine_close(ranks, engine_inputs)
    assert sorted(tuple(r["coords"]) for _, r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


# --------------------------------------------------------- pipelines
@pytest.mark.parametrize("key", sorted(_model_pipelines()))
def test_pipelines_on_the_model_axis_match_one_process(model_run, key):
    """SD-1.5, SDXL, ControlNet with IP-Adapter and SD3 with T5 (resident,
    split with the MMDiT) at ``mesh_model=2``: every rank the whole batch,
    within 1e-5 of the one-process pipeline; ``placements`` records the
    split weights of the UNet (ControlNet, MMDiT, T5) and no other
    module's."""
    (a0, r0), (a1, _) = model_run[1]
    assert np.array_equal(a0[key], a1[key])
    want = _one_pipeline(*_model_pipelines()[key])
    assert a0[key].shape == want.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(a0[key], want, atol=1e-5)
    placed = r0[key + ":placements"]
    split_modules = {"unet", "controlnet", "t5"}
    assert all(placed[m] for m in placed if m in split_modules)
    assert not any(placed[m] for m in placed if m not in split_modules)
    if key == "sd3_t5":
        assert "encoder.block.0.layer.1.DenseReluDense.wo.weight" in placed["t5"]


@pytest.mark.parametrize("key", sorted(_seq_pipelines()))
def test_pipelines_on_the_seq_axis_match_one_process(seq_run, key):
    """SD-1.5 inpainting (the mask, source and blend noise cut by rows), a
    ControlNet (the control image cut by pixel rows, its conditioning
    embedding's convs halo'd), SD3 with T5 (the MMDiT's patch rows, the
    sincos table's rows offset by the rank, the image K/V gathered) and
    SD3 with DiT-ToMe 0.5 (each block's image tokens gathered, the match
    over the whole patch grid) at ``mesh_seq=2``: within 1e-5 of one
    process."""
    (a0, _), (a1, _) = seq_run[1]
    assert np.array_equal(a0[key], a1[key])
    want = _one_pipeline(*_seq_pipelines()[key])
    np.testing.assert_allclose(a0[key], want, atol=1e-5)


# ------------------------------------------------------- entry points
def test_cli_mesh_model_two_ranks_matches_one_process(model_run, tmp_path, monkeypatch):
    """``cli.run`` of configs/smoke.yaml (fp32) with ``--set
    model.mesh_model=2``: both ranks print the same table, rank 0 alone
    writes the run directory, its PNGs are the one-process run's within
    one level (images within 1e-5 round to uint8 alike but where one sits
    on a rounding edge) and the CLIP scores, taken on those uint8 images,
    equal the one-process run's within 1e-4 relative."""
    out, ranks = model_run
    assert ranks[0][1]["cli"] == ranks[1][1]["cli"]
    assert not (out / "cwd1" / "outputs").exists()
    run_dir = [d for d in (out / "cwd0" / "outputs").iterdir() if d.name != "smoke"][0]
    monkeypatch.chdir(tmp_path)
    from sonicdiffusionbayeslab_torch import cli

    one = cli.run(str(REPO / "configs" / "smoke.yaml"), {**_cli_overrides(), **CLI_FP32},
                  device="cpu")
    got = _tsv(run_dir / "tables" / "final.tsv")
    one_dir = [d for d in (tmp_path / "outputs").iterdir() if d.name != "smoke"][0]
    want = _tsv(one_dir / "tables" / "final.tsv")
    assert [(g["exp"], g["nfe"]) for g in got] == [(w["exp"], w["nfe"]) for w in want]
    from sonicdiffusionbayeslab_torch.data.imageio import read_image

    pngs = sorted((out / "cwd0" / "outputs" / "smoke").rglob("*.png"))
    assert len(pngs) == 6
    for png in pngs:
        mine = np.rint(read_image(str(png)) * 255.0)
        theirs = np.rint(read_image(str(tmp_path / png.relative_to(out / "cwd0"))) * 255.0)
        diff = np.abs(mine - theirs)
        # a value within 1e-5 of a rounding edge: ~2 * 255 * 1e-5 of them
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, png.name
    np.testing.assert_allclose(ranks[0][1]["cli"]["clip_score"], one["clip_score"], rtol=1e-4)


def test_fuse_lora_on_the_model_axis_is_one_process_cut(model_run):
    """``fuse_lora`` on a pipeline split at ``mesh_model=2``: every rank's
    weights are bit-equal to one process's fused weights cut to its share
    (q/k/v are split, so the merge ran on gathered weights)."""
    for _, res in model_run[1]:
        fuse = res["fuse"]
        assert fuse["modules"] > 0 and fuse["changed"] >= fuse["modules"] and fuse["cut"] > 0
        assert fuse["bad"] == []


def test_served_request_mesh_model_matches_one_process(model_run):
    """One request through rank 0's server over a ``mesh_model=2`` pipeline,
    rank 1 following: the one-process pipeline's image (stream 2·seed + 1)
    within 1e-5."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel

    (a0, _), (_, r1) = model_run[1]
    assert r1["follower_calls"] == 1
    single = StableDiffusionModel(**PIPE_KW)
    single.scheduler = S.DPMSolverScheduler(solver_order=2)
    want, _, _ = single(["a served lighthouse"], num_inference_steps=3, guidance_scale=7.5,
                        negative_prompt=[""], sample_indices=[201])
    np.testing.assert_allclose(a0["served"], want[0], atol=1e-5)


# ---------------------------------------------------------- refusals
def test_what_stays_refused_names_a9b(tmp_path):
    """Only training with seq above 1 stays refused, saying that the JAX
    loop has no seq axis, the training loop's refusal before it builds
    anything; sampling under seq and training under model pass the check,
    and a loop at ``mesh_data: 1, mesh_model: 2`` in one process asks the
    world for its two-rank mesh (tests/test_torch_split_training.py runs
    it on two ranks)."""
    from test_torch_train_loop import _config

    from sonicdiffusionbayeslab_torch.training.loop import run_training

    with pytest.raises(NotImplementedError, match="has no seq axis"):
        M.check_supported("x", mesh_seq=2, training=True)
    M.check_supported("x", mesh_seq=2)
    M.check_supported("x", mesh_seq=1, training=True)
    with pytest.raises(NotImplementedError, match="training loop has no seq axis"):
        run_training(_config(tmp_path, {"mesh_seq": 2, "batch_size": 2}))
    with pytest.raises(ValueError, match="mesh 1x1x2 != 1 processes"):
        run_training(_config(tmp_path, {"mesh_data": 1, "mesh_model": 2, "batch_size": 2}))


def test_latent_sharding_splits_the_height_or_raises():
    """Without a process group the shares are the whole; a seq axis
    splits rows [r·h/n, (r+1)·h/n) and refuses a height that it (times the
    UNet's downsampling) does not divide."""
    s = M.latent_sharding(None, 8)
    assert s.height.rows(64) == slice(0, 64)
    shard = M.RowShard(1, 4, "seq", "latent height", 8)
    assert shard.rows(64) == slice(16, 32)
    with pytest.raises(ValueError, match="latent height 48 not divisible by seq axis 4 x 8"):
        shard.rows(48)


def test_resnet_refuses_a_model_axis_that_does_not_divide_its_groups():
    """A resnet of 48 channels has gcd(48, 32) = 16 groups; 3 ranks cannot
    split them without changing the statistics, so placing it raises."""
    from sonicdiffusionbayeslab_torch.models.layers import ResnetBlock

    ctx = M.ParallelContext(None, 1, 0, 3, 0)
    with pytest.raises(ValueError, match="mesh_model 3 must divide"):
        M.place_module(ResnetBlock(32, 48, 64), ctx)
