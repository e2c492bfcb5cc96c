"""The port's multi-process layer (``parallel/``) on the CPU: gloo ranks in
subprocesses against one-process runs and the JAX package.

Each 2-rank session starts two processes (``initialize`` over a free
port, one torch thread each) that write their results into ``tmp_path``;
the tests compare them with one-process runs made here.  Data-parallel
sampling is bit-equal to one-process runs of each rank's rows (the same
shapes give the same sums) and within 1e-5 of the JAX package's 8-device
mesh; pipelines, the CLI and the server hold to one-process runs of the
whole batch (a rank's batch is half as large, so CPU matmuls may sum in
another order); training holds losses and adapter updates within 1e-5
relative.  The tensor-parallel placements (``shard_params``) are held to
the JAX package's ``_TP_RULES`` parameter by parameter.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_adam_close, random_params, randn, step_lrs, t, tiny_engines
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.parallel import mesh as M
from sonicdiffusionbayeslab_torch.registry import load_all_plugins, models_registry

REPO = Path(__file__).resolve().parents[1]
RANKS = 2
PROMPTS = ["a cat", "a dog", "a boat", "a lighthouse"]

_HEAD = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from sonicdiffusionbayeslab_torch.parallel import distributed as D
D.initialize(coordinator=sys.argv[1], num_processes=int(sys.argv[2]),
             process_id=int(sys.argv[3]), device="cpu")
R = D.rank()
OUT = sys.argv[4]
ARGS = json.load(open(OUT + "/args.json"))
"""
# Every rank leaves together and closes its group before the interpreter
# exits, so that no gloo thread is still reading from a rank that is gone.
_TAIL = """
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(body: str, out: Path, args=None, n: int = RANKS, timeout: float = 240):
    """Run ``_HEAD + body`` as ``n`` gloo ranks; every rank must exit 0.
    Returns each rank's stdout."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "args.json").write_text(json.dumps(args or {}))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    addr = f"localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _HEAD + body + _TAIL, addr, str(n), str(r),
                               str(out)], cwd=out, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{o}"
    return outs


# ------------------------------------------------------ sums and the mesh
_SUMS = """
from sonicdiffusionbayeslab_torch.metrics.metrics import TimeMetric
from sonicdiffusionbayeslab_torch.parallel import all_sum_array, all_sum_scalar, make_mesh
from sonicdiffusionbayeslab_torch.parallel import mesh as M
m = TimeMetric()
m.update(2.0 * (R + 1), 2)  # global: 6 s over 4 images
res = dict(scalar=all_sum_scalar(float(R + 1)), array=all_sum_array(np.full(3, R + 1.0)).tolist(),
           sec_per_image=m.compute(), exact=all_sum_scalar(1.0 if R == 0 else 2.0))
try:
    make_mesh(n_data=3, n_model=3)
except ValueError as e:
    res["bad_mesh"] = str(e)
mesh = make_mesh()
res["sizes"] = [M.axis_size(mesh, a) for a in M.AXES]
res["rows"] = [M.shard_batch(mesh, np.arange(8)).tolist(),
               M.shard_latents(mesh, np.arange(4)).tolist()]
try:
    M.shard_batch(mesh, np.arange(3))
except ValueError as e:
    res["odd_batch"] = str(e)
json.dump(res, open(OUT + f"/rank{R}.json", "w"))
"""


@pytest.fixture(scope="module")
def sums(tmp_path_factory):
    out = tmp_path_factory.mktemp("sums")
    run_ranks(_SUMS, out)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(RANKS)]


def test_two_process_global_reduction(sums):
    """all_sum_* and a metric's compute() give global values on every rank
    (the JAX package's test_two_process_global_reduction), exactly."""
    for r in sums:
        assert r["scalar"] == 3.0 and r["exact"] == 3.0
        assert r["array"] == [3.0, 3.0, 3.0]
        assert abs(r["sec_per_image"] - 1.5) < 1e-12


def test_make_mesh_on_two_ranks_and_row_shards(sums):
    for rank, r in enumerate(sums):
        assert "mesh 3x1x3 != 2" in r["bad_mesh"]
        assert r["sizes"] == [2, 1, 1]
        assert r["rows"] == [list(range(4 * rank, 4 * rank + 4)), [2 * rank, 2 * rank + 1]]
        assert "not divisible by data axis 2" in r["odd_batch"]


def test_make_mesh_validates_without_a_process_group():
    """One process: the JAX package's ValueError for a 3x3 mesh (in a world
    of 8 there; of 1 here), a one-rank mesh is None (the single-device
    path), a row shard of one rank is the whole batch."""
    from sonicdiffusionbayeslab_tpu.parallel import make_mesh as jax_make_mesh

    with pytest.raises(ValueError, match="devices"):
        jax_make_mesh(n_data=3, n_model=3)
    with pytest.raises(ValueError, match="mesh 3x1x3 != 1 processes"):
        M.make_mesh(n_data=3, n_model=3)
    with pytest.raises(ValueError, match="mesh 2x1x1"):
        M.make_mesh(n_data=2)
    assert M.make_mesh() is None and M.make_mesh(1) is None
    assert M.axis_size(None, "data") == 1
    assert M.shard_batch(None, np.arange(3)).tolist() == [0, 1, 2]


# ------------------------------------------------------------- TP rules
def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _tp_models():
    """(name, JAX params of the tiny model, the port's name map)."""
    from sonicdiffusionbayeslab_torch.models.mmdit import MMDiTConfig
    from sonicdiffusionbayeslab_torch.models.t5 import T5Config
    from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
    from sonicdiffusionbayeslab_tpu import models as jm
    from sonicdiffusionbayeslab_tpu.models import mmdit as JM
    from sonicdiffusionbayeslab_tpu.models import t5 as JT

    unet = jax.eval_shape(jm.UNet2DCondition(jm.UNetConfig.tiny()).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)))
    mmdit = jax.eval_shape(JM.MMDiT(JM.MMDiTConfig.tiny()).init, jax.random.PRNGKey(0),
                           jnp.zeros((1, 8, 8, 16)), jnp.zeros((1,)), jnp.zeros((1, 7, 40)),
                           {"text_embeds": jnp.zeros((1, 32))})
    tc = T5Config.tiny()
    t5 = jax.eval_shape(JT.T5Encoder(JT.T5Config.tiny()).init, jax.random.PRNGKey(0),
                        jnp.zeros((1, tc.max_length), jnp.int32))
    return [("unet", random_params(unet["params"], 1), W.unet_name_map(UNetConfig.tiny())),
            ("mmdit", random_params(mmdit["params"], 2), W.mmdit_name_map(MMDiTConfig.tiny())),
            ("t5", random_params(t5["params"], 3), W.t5_name_map(tc.num_layers))]


def _torch_dim(spec, ndim):
    """The torch dim a JAX kernel spec splits over "model" (None:
    replicated): [in, out] -> [out, in]; [h, w, in, out] -> [out, in, h, w]."""
    axes = [i for i, s in enumerate(tuple(spec) + (None,) * ndim) if s == "model"]
    if not axes:
        return None
    return {1: 0, 0: 1}[axes[0]] if ndim == 2 else {3: 0, 2: 1}[axes[0]]


_TP = """
from sonicdiffusionbayeslab_torch.parallel import make_mesh, shard_params
from torch.distributed.tensor import Shard
mesh = make_mesh(n_data=1, n_model=2)
local = {}
for key, sd in torch.load(OUT + "/sds.pt").items():
    for name, dt in shard_params(sd, mesh).items():
        dims = [p.dim for p in dt.placements if isinstance(p, Shard)]
        local[f"{key}:{name}"] = (dims[0] if dims else -1, dt.to_local().clone())
torch.save(local, OUT + f"/rank{R}.pt")
"""


def test_shard_params_places_like_the_jax_tp_rules(tmp_path):
    """At n_model 2 (the JAX package on its 8-device CPU mesh, 4 x 1 x 2;
    the port on 2 gloo ranks, 1 x 1 x 2), for every parameter of the tiny
    UNet, MMDiT and T5, through the port's name maps: the same split axis
    (or replicated, the divisibility guard included) and each model
    index's local slice equal to the JAX shard's."""
    from sonicdiffusionbayeslab_tpu.parallel import make_mesh as jax_make_mesh
    from sonicdiffusionbayeslab_tpu.parallel import shard_params as jax_shard_params

    jmesh = jax_make_mesh(n_data=4, n_model=2)
    devs = [jmesh.devices[0, 0, m] for m in range(2)]
    sds, want = {}, {}
    split = 0
    for key, params, nm in _tp_models():
        placed = jax_shard_params(params, jmesh)
        sds[key] = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
            name, fwd = nm[_path_str(path)]
            full = fwd(np.asarray(leaf, np.float32))
            sds[key][name] = torch.from_numpy(np.array(full))
            dim = _torch_dim(leaf.sharding.spec, leaf.ndim)
            assert M.param_placement(name, full.shape, 2) == dim, (key, name, leaf.sharding.spec)
            shards = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
            want[f"{key}:{name}"] = (-1 if dim is None else dim,
                                     [fwd(shards[d].astype(np.float32)) for d in devs])
            split += dim is not None
    assert split > 50  # the rules split most projections and convs
    torch.save(sds, tmp_path / "sds.pt")
    run_ranks(_TP, tmp_path)
    for m in range(2):
        got = torch.load(tmp_path / f"rank{m}.pt")
        assert set(got) == set(want)
        for k, (dim, local) in got.items():
            assert dim == want[k][0], k
            np.testing.assert_array_equal(local.numpy(), want[k][1][m], err_msg=k)


def test_param_placement_guard_and_replication():
    assert M.param_placement("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
                             (32, 32), 2) == 0
    assert M.param_placement("x.attn1.to_out.0.weight", (32, 32), 2) == 1
    assert M.param_placement("x.attn1.to_out.0.weight", (32, 30), 4) is None  # 30 % 4
    assert M.param_placement("x.attn1.to_out.0.bias", (32,), 2) is None
    assert M.param_placement("x.attn1.to_q.weight", (32, 32), 1) is None


# ------------------------------------------------ engines and pipelines
_SAMPLE = """
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine
from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
from sonicdiffusionbayeslab_torch.parallel import make_mesh
from sonicdiffusionbayeslab_torch.registry import load_all_plugins, models_registry
load_all_plugins()
mesh = make_mesh()
arrays, res = {}, {}
eng = StableDiffusionEngine(UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                            dtype=torch.float32, device="cpu")
eng.load_state_dicts(torch.load(OUT + "/sds.pt"))
inp = np.load(OUT + "/inputs.npz")
emb, neg = torch.from_numpy(inp["emb"]), torch.from_numpy(inp["neg"])
plan = S.DPMSolverScheduler(solver_order=2).build_plan(3)
out = eng.sample(plan, emb, neg, guidance_scale=7.5, latent_hw=(8, 8),
                 init_latents=inp["lat0"], collect_x0=True, x0_samples=5, mesh=mesh)
arrays.update(engine=out.images.numpy(), engine_latents=out.latents.numpy(),
              engine_x0=out.x0_images.numpy())
res["engine_time"] = out.execution_time
arrays["cfg_prefix"] = eng.sample(plan, emb, neg, guidance_scale=7.5, latent_hw=(8, 8),
                                  init_latents=inp["lat0"], mesh=mesh,
                                  cfg_prefix=True).images.numpy()
lcm = S.LCMScheduler().build_plan(4)
arrays["lcm"] = eng.sample(lcm, emb, None, seed=3, guidance_scale=1.0, latent_hw=(8, 8),
                           sample_indices=np.arange(10, 18), mesh=mesh).images.numpy()
try:
    eng.sample(plan, emb[:3], neg[:3], latent_hw=(8, 8), mesh=mesh)
except ValueError as e:
    res["odd_batch"] = str(e)
kw = dict(pretrained_model="x", tiny=True, image_size=64, dtype="float32", device="cpu",
          mesh_data=2)
call = dict(num_inference_steps=3, guidance_scale=5.0, seed=7)
for name, extra, args in ARGS["pipelines"]:
    p = models_registry[name](**kw, **extra)
    if name.startswith("stable_diffusion_3"):
        p.scheduler = S.FlowMatchEulerScheduler()
    res[name + ":placements"] = sorted(p.placements)
    a = {k: (np.asarray(v, np.float32) if isinstance(v, list) else v) for k, v in args.items()}
    key = name + str(sorted(extra.items())) + str(sorted(args))
    arrays[key] = p(ARGS["prompts"], **call, **a)[0]
np.savez(OUT + f"/rank{R}.npz", **arrays)
json.dump(res, open(OUT + f"/rank{R}.json", "w"))
"""


def _pipeline_cases():
    rng = np.random.default_rng(3)
    init = rng.random((4, 16, 16, 3)).tolist()
    mask = (rng.random((4, 16, 16)) > 0.5).astype(np.float32).tolist()
    return [
        ("stable_diffusion_model", {}, {}),
        ("stable_diffusion_model", {}, {"init_image": init, "mask_image": mask,
                                        "strength": 0.7}),
        ("stable_diffusion_model", {"variant": "sd21"}, {}),
        ("stable_diffusion_xl_model", {}, {}),
        ("stable_diffusion_3_model", {}, {}),
        ("stable_diffusion_controlnet_model", {"ip_adapter": "missing.bin"},
         {"control_image": rng.random((4, 64, 64, 3)).tolist(),
          "ip_image_embeds": rng.standard_normal((4, 1024)).tolist()}),
    ]


@pytest.fixture(scope="module")
def sampled(tmp_path_factory):
    """The JAX tiny engine's inputs (batch 8: its 8-device mesh), the 2-rank
    session's outputs, and the inputs' arrays."""
    jeng, params, teng = tiny_engines()
    from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer

    tok = HashTokenizer(vocab_size=1000)
    prompts = [f"prompt {i}" for i in range(8)]
    emb = np.asarray(jeng.encode_prompts(params, tok(prompts)))
    neg = np.asarray(jeng.encode_prompts(params, tok([""] * 8)))
    lat0 = randn((8, 8, 8, 4), 5)
    out = tmp_path_factory.mktemp("sample")
    np.savez(out / "inputs.npz", emb=emb, neg=neg, lat0=lat0)
    torch.save({m: teng_m.state_dict() for m, teng_m in zip(teng.MODULES, teng.modules())},
               out / "sds.pt")
    run_ranks(_SAMPLE, out, {"pipelines": _pipeline_cases(), "prompts": PROMPTS})
    ranks = [(dict(np.load(out / f"rank{r}.npz")), json.loads((out / f"rank{r}.json").read_text()))
             for r in range(RANKS)]
    return dict(emb=emb, neg=neg, lat0=lat0, ranks=ranks, jax=(jeng, params), teng=teng)


def test_engine_data_parallel_is_bit_equal_to_each_ranks_rows(sampled):
    """Every rank returns the whole batch; rank r's rows are bit-equal to a
    one-process run of rows 4r..4r+3 (the same UNet batch), x0 decodes
    cut to ``x0_samples``, the loop time the ranks' largest."""
    teng = sampled["teng"]
    plan = S.DPMSolverScheduler(solver_order=2).build_plan(3)
    (a0, r0), (a1, r1) = sampled["ranks"]
    for k in ("engine", "engine_latents", "engine_x0", "lcm"):
        assert np.array_equal(a0[k], a1[k]), k
    assert r0["engine_time"] == r1["engine_time"] > 0
    # The CFG shared prefix on each rank's rows: the same math.
    assert np.array_equal(a0["cfg_prefix"], a1["cfg_prefix"])
    np.testing.assert_allclose(a0["cfg_prefix"], a0["engine"], atol=1e-5)
    assert a0["engine_x0"].shape == (3, 5, 16, 16, 3)
    lcm = S.LCMScheduler().build_plan(4)
    for r in range(RANKS):
        rows = slice(4 * r, 4 * r + 4)
        one = teng.sample(plan, t(sampled["emb"][rows]), t(sampled["neg"][rows]),
                          guidance_scale=7.5, latent_hw=(8, 8),
                          init_latents=t(sampled["lat0"][rows]), collect_x0=True)
        assert np.array_equal(a0["engine"][rows], one.images.numpy())
        assert np.array_equal(a0["engine_latents"][rows], one.latents.numpy())
        n = min(4, 5 - 4 * r)  # x0 decodes of the batch's first 5 samples
        np.testing.assert_array_equal(a0["engine_x0"][:, 4 * r:4 * r + n],
                                      one.x0_images.numpy()[:, :n])
        # LCM draws noise at every step: sample i's from (seed, i, step).
        one = teng.sample(lcm, t(sampled["emb"][rows]), None, seed=3, guidance_scale=1.0,
                          latent_hw=(8, 8), sample_indices=np.arange(10, 18)[rows])
        assert np.array_equal(a0["lcm"][rows], one.images.numpy())
    assert "batch 3 not divisible by data axis 2" in r0["odd_batch"]


def test_engine_data_parallel_matches_the_jax_8_device_mesh(sampled):
    """The JAX engine's ``sample(mesh=make_mesh(n_data=8))`` on the same
    weights, embeddings, initial latents and plan rows: images (in [0, 1])
    within 1e-5, final latents (|x| up to ~7) within 1e-5 of their largest
    magnitude (CFG 7.5 scales the two frameworks' fp32 summation-order
    differences)."""
    from sonicdiffusionbayeslab_tpu import schedulers as JS
    from sonicdiffusionbayeslab_tpu.parallel import make_mesh as jax_make_mesh
    from sonicdiffusionbayeslab_tpu.parallel import shard_params as jax_shard_params

    jeng, params = sampled["jax"]
    mesh = jax_make_mesh(n_data=8)
    plan = JS.DPMSolverScheduler(solver_order=2).build_plan(3)
    with mesh:
        want = jeng.sample(jax_shard_params(params, mesh), plan, jnp.asarray(sampled["emb"]),
                           jnp.asarray(sampled["neg"]), jax.random.PRNGKey(0),
                           guidance_scale=7.5, latent_hw=(8, 8),
                           init_latents=jnp.asarray(sampled["lat0"]), mesh=mesh)
    got = sampled["ranks"][0][0]
    np.testing.assert_allclose(got["engine"], np.asarray(want.images), atol=1e-5)
    want_lat = np.asarray(want.latents)
    np.testing.assert_allclose(got["engine_latents"], want_lat,
                               atol=1e-5 * float(np.abs(want_lat).max()))


@pytest.mark.parametrize("case", range(len(_pipeline_cases())))
def test_pipeline_mesh_data_matches_one_process(sampled, case):
    """``mesh_data=2`` pipelines (SD-1.5 text-to-image and inpainting,
    SD-2.1, SDXL, SD3, ControlNet with IP-Adapter) give every rank the whole batch, equal
    to the one-process pipeline's within 1e-5, with every module's weights
    placed on the mesh, replicated."""
    load_all_plugins()
    name, extra, args = _pipeline_cases()[case]
    key = name + str(sorted(extra.items())) + str(sorted(args))
    (a0, r0), (a1, _) = sampled["ranks"]
    assert np.array_equal(a0[key], a1[key])
    one = models_registry[name](pretrained_model="x", tiny=True, image_size=64, dtype="float32",
                                device="cpu", **extra)
    if name.startswith("stable_diffusion_3"):
        one.scheduler = S.FlowMatchEulerScheduler()
    arr = {k: (np.asarray(v, np.float32) if isinstance(v, list) else v) for k, v in args.items()}
    want = one(PROMPTS, num_inference_steps=3, guidance_scale=5.0, seed=7, **arr)[0]
    assert a0[key].shape == want.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(a0[key], want, atol=1e-5)
    modules = set(one.engine.MODULES) | ({"image_proj"} if one.has_ip else set()) | (
        {"controlnet"} if "controlnet" in name else set())
    assert set(r0[name + ":placements"]) == modules


def test_pipelines_refuse_seq_and_model_axes_naming_a9():
    """The seq and model axes run (tests/test_torch_tensor_parallel.py); a
    pipeline asks the world for its mesh like the data axis does; ToMe with
    seq and int8 with either axis pass the check, and training with seq,
    which the JAX loop has no mode for, stays refused."""
    load_all_plugins()
    for name, kw, mesh in (("stable_diffusion_model", {"mesh_model": 2}, "1x1x2"),
                           ("stable_diffusion_model", {"mesh_seq": 2}, "1x2x1"),
                           ("stable_diffusion_3_model", {"mesh_seq": 4}, "1x4x1"),
                           ("stable_diffusion_controlnet_model", {"mesh_model": 2}, "1x1x2")):
        with pytest.raises(ValueError, match=f"mesh {mesh} != 1 processes"):
            models_registry[name](pretrained_model="x", tiny=True, dtype="float32",
                                  device="cpu", **kw)
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 processes"):
        models_registry["stable_diffusion_model"](pretrained_model="x", tiny=True,
                                                  dtype="float32", device="cpu", mesh_data=2)
    M.check_supported("engine.sample", mesh_seq=2)
    with pytest.raises(NotImplementedError, match="training loop has no seq axis"):
        M.check_supported("training", mesh_seq=2, training=True)


# ------------------------------------------------------------------ CLI
_CLI = """
import os
from pathlib import Path
from sonicdiffusionbayeslab_torch import cli
os.chdir(OUT + f"/cwd{R}")
table = cli.run(ARGS["config"], ARGS["overrides"], device="cpu")
json.dump(table, open(OUT + f"/rank{R}.json", "w"))
"""


def _cli_overrides():
    return {"dataset.max_count": 6, "inference.batch_size": 4, "inference.batch_count": 2,
            "experiment_params.num_inference_steps": [3],
            "dataset.prompts": str(REPO / "data/dataset/prompts_sample.json"),
            "quality_metrics": {"clip_score": {"model_name_or_path": "x"}}}


def _tsv(path):
    lines = Path(path).read_text().splitlines()
    cols = lines[0].split("\t")
    return [dict(zip(cols, ln.split("\t"))) for ln in lines[1:]]


def test_cli_mesh_data_two_ranks_matches_one_process(tmp_path, monkeypatch):
    """``cli.run`` of configs/smoke.yaml with ``model.mesh_data=2`` on two
    ranks: both ranks print the same table, rank 0 alone writes the run
    directory (events, tables, grids, PNGs, sweep state), and its
    ``tables/final.tsv`` equals the one-process run's: the same points and
    NFE, the CLIP score within 1e-5 (each rank scores its rows of a
    validation batch, the last batch's 2 rows one each), the time a
    positive number."""
    config = str(REPO / "configs" / "smoke.yaml")
    overrides = _cli_overrides()
    for r in range(RANKS):
        (tmp_path / f"cwd{r}").mkdir()
    run_ranks(_CLI, tmp_path, {"config": config,
                               "overrides": {**overrides, "model.mesh_data": 2}})
    tables = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(RANKS)]
    assert tables[0] == tables[1]
    assert not (tmp_path / "cwd1" / "outputs").exists()
    run_dirs = [d for d in (tmp_path / "cwd0" / "outputs").iterdir() if d.name != "smoke"]
    assert len(run_dirs) == 1
    written = {p.relative_to(run_dirs[0]).as_posix() for p in run_dirs[0].rglob("*")}
    assert {"events.jsonl", "tables/final.tsv", "metrics.tsv", "sweep_state.json"} <= written
    pngs = sorted(p.name for p in (tmp_path / "cwd0" / "outputs" / "smoke").rglob("*.png"))
    assert len(pngs) == 6

    monkeypatch.chdir(tmp_path)
    from sonicdiffusionbayeslab_torch import cli

    one = cli.run(config, overrides, device="cpu")
    one_dir = [d for d in (tmp_path / "outputs").iterdir() if d.name != "smoke"][0]
    got, want = _tsv(run_dirs[0] / "tables" / "final.tsv"), _tsv(one_dir / "tables" / "final.tsv")
    assert [(g["exp"], g["nfe"]) for g in got] == [(w["exp"], w["nfe"]) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g["clip_score"]), float(w["clip_score"]), rtol=1e-5)
        assert float(g["time"]) > 0
    assert pngs == sorted(p.name for p in (tmp_path / "outputs" / "smoke").rglob("*.png"))
    np.testing.assert_allclose(tables[0]["clip_score"], one["clip_score"], rtol=1e-5)


# ------------------------------------------------------------- training
_TRAIN = """
from sonicdiffusionbayeslab_torch.config import ConfigNode, validate_config
from sonicdiffusionbayeslab_torch.training.loop import run_training
from sonicdiffusionbayeslab_torch.training.trainer import leaves
res = {}
inp = np.load(OUT + "/grad_inputs.npz")
rows = slice(2 * R, 2 * R + 2)
for tag, raw in ARGS["configs"].items():
    out = run_training(validate_config(ConfigNode(raw)))
    res[tag] = out["losses"]
    torch.save({k: v.detach() for k, v in leaves(out["state"].trainable).items()},
               OUT + f"/{tag}_rank{R}.pt")
    # One step's loss and gradients on fixed inputs: this rank's rows.
    tr = out["trainer"]
    state = tr.init_state(generator=torch.Generator().manual_seed(1))
    args = [torch.from_numpy(inp[k][rows]) for k in ("lat", "ctx", "unc")[:2 + (tag == "distill")]]
    loss, grads = tr.value_and_grad(state, *args, generator=torch.Generator().manual_seed(5))
    torch.save({"loss": loss, **grads}, OUT + f"/{tag}_grads_rank{R}.pt")
json.dump(res, open(OUT + f"/rank{R}.json", "w"))
"""

TRAIN_MODES = {
    "lora": {"lora_rank": 4, "learning_rate": 1e-2, "prefetch": 2, "snr_gamma": 5.0},
    "distill": {"mode": "distill", "lora_rank": 4, "learning_rate": 1e-2,
                "original_inference_steps": 10, "prefetch": 0},
}


def test_training_data_parallel_matches_one_process(tmp_path, capsys):
    """LoRA (diffusion, min-SNR, prefetch 2) and LCM-LoRA distillation on
    two ranks (2 rows each; the prep's and the trainer's draws the global
    batch's, the gradients averaged) against one process at the global
    batch 4.  One step on fixed inputs: the loss within 1e-5 relative and
    every gradient within 1e-5 of its tensor's largest entry.  The loop, 2
    steps: each logged loss within 1e-5 relative, both ranks' adapters
    equal and held to the one-process adapters by ``assert_adam_close``
    (AdamW's normalised step turns the gradients' ~1e-7 relative rounding
    differences into up to ~2e-4 of an update at single entries), and
    only rank 0 saves."""
    from test_torch_train_loop import _config

    from sonicdiffusionbayeslab_torch.training.loop import run_training
    from sonicdiffusionbayeslab_torch.training.trainer import leaves

    grad_in = {"lat": randn((4, 8, 8, 4), 11), "ctx": randn((4, 77, 32), 12),
               "unc": randn((4, 77, 32), 13)}
    np.savez(tmp_path / "grad_inputs.npz", **grad_in)
    configs, ones = {}, {}
    for tag, training in TRAIN_MODES.items():
        common = {**training, "num_steps": 2, "batch_size": 4, "log_every": 1}
        cfg = _config(tmp_path / f"data_{tag}", common)
        ones[tag] = run_training(cfg)
        raw = cfg.to_dict()
        raw["training"] = {**raw["training"], "mesh_data": 2,
                           "save_dir": str(tmp_path / f"save_{tag}")}
        configs[tag] = raw
    run_ranks(_TRAIN, tmp_path, {"configs": configs})
    res = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(RANKS)]
    assert (tmp_path / "save_lora" / "final" / "lora_peft.npz").exists()
    for tag, one in ones.items():
        assert res[0][tag] == res[1][tag]
        np.testing.assert_allclose(res[0][tag], one["losses"], rtol=1e-5)
        init = {k: v.detach() for k, v in leaves(one["trainer"].init_state(
            generator=_init_generator(one)).trainable).items()}
        want = {k: v.detach() for k, v in leaves(one["state"].trainable).items()}
        got = [torch.load(tmp_path / f"{tag}_rank{r}.pt") for r in range(RANKS)]
        assert set(got[0]) == set(want)
        for k, w in want.items():
            assert torch.equal(got[0][k], got[1][k]), k
            assert not torch.equal(w, init[k]), k  # every adapter tensor moved
            assert_adam_close(got[0][k], w, step_lrs(1e-2, 2))
        tr = one["trainer"]
        state = tr.init_state(generator=torch.Generator().manual_seed(1))
        args = [t(grad_in[k]) for k in ("lat", "ctx", "unc")[:2 + (tag == "distill")]]
        loss, grads = tr.value_and_grad(state, *args, generator=torch.Generator().manual_seed(5))
        for r in range(RANKS):
            got = torch.load(tmp_path / f"{tag}_grads_rank{r}.pt")
            np.testing.assert_allclose(float(got.pop("loss")), float(loss), rtol=1e-5)
            assert set(got) == set(grads)
            for k, g in grads.items():
                top = float(g.abs().max())
                assert float((got[k] - g).abs().max()) <= 1e-5 * top, (tag, k)


def _init_generator(out):
    """The loop's generator of the adapters' initial ``a`` (seed 29,
    stream 0), for the one-process run's initial state."""
    from sonicdiffusionbayeslab_torch.training.loop import _generator

    return _generator(out["engine"].device, 29, 0)


def test_training_refuses_a_world_that_does_not_fit(tmp_path):
    from test_torch_train_loop import _config

    from sonicdiffusionbayeslab_torch.training.loop import run_training

    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 processes"):
        run_training(_config(tmp_path, {"mesh_data": 2, "batch_size": 2}))


# -------------------------------------------------------------- serving
_SERVE = """
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
from sonicdiffusionbayeslab_torch.serving import GenerateRequest, InferenceServer, follow
pipe = StableDiffusionModel("x", tiny=True, image_size=64, dtype="float32", device="cpu",
                            mesh_data=2)
pipe.scheduler = S.DPMSolverScheduler(solver_order=2)
if R == 0:
    srv = InferenceServer(pipe, max_batch=8, max_wait_ms=500.0, readback_dtype="float32")
    try:
        futs = [srv.submit(GenerateRequest(f"prompt {i}", num_inference_steps=3, seed=100 + i))
                for i in range(8)]
        outs = [f.result(timeout=180) for f in futs]
    finally:
        srv.shutdown()
    np.save(OUT + "/images.npy", np.stack([o["image"] for o in outs]))
    json.dump({"batch_sizes": [o["batch_size"] for o in outs], "stats": srv.stats},
              open(OUT + "/rank0.json", "w"))
else:
    json.dump({"calls": follow(pipe)}, open(OUT + f"/rank{R}.json", "w"))
"""


def test_serving_over_two_data_parallel_ranks(tmp_path):
    """8 requests through rank 0's ``InferenceServer`` over a
    ``mesh_data=2`` pipeline, rank 1 following its calls until the stop:
    the single pipeline's images (the server's streams 2·seed + 1) within
    ``tests/test_serving_mesh.py``'s 2e-4."""
    run_ranks(_SERVE, tmp_path)
    r0 = json.loads((tmp_path / "rank0.json").read_text())
    r1 = json.loads((tmp_path / "rank1.json").read_text())
    assert r1["calls"] == r0["stats"]["batches"] >= 1
    assert max(r0["batch_sizes"]) == 8 and r0["stats"]["errors"] == 0
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel

    single = StableDiffusionModel("x", tiny=True, image_size=64, dtype="float32", device="cpu")
    single.scheduler = S.DPMSolverScheduler(solver_order=2)
    want, _, _ = single([f"prompt {i}" for i in range(8)], num_inference_steps=3,
                        guidance_scale=7.5, negative_prompt=[""] * 8,
                        sample_indices=np.arange(100, 108) * 2 + 1)
    np.testing.assert_allclose(np.load(tmp_path / "images.npy"), want, rtol=2e-4, atol=2e-4)
