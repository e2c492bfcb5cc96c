"""The port's DeepCache (the UNet's shallow/trunk split and the engine's
cache schedule), noise-injecting LCM runs and LoRA merge against the JAX
package (tiny configs, fp32, CPU), and the CUDA-graph variants'
bookkeeping."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, jax_step_noise, randn, t, tiny_engines
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
from sonicdiffusionbayeslab_torch.models.sampler import CachePlan
from sonicdiffusionbayeslab_torch.models.weights import merge_lora, state_dicts_from_jax
from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall, GraphedVariants
from sonicdiffusionbayeslab_torch.utils.rng import per_sample_step_noise
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models import weights as JW
from sonicdiffusionbayeslab_tpu.models.sampler import CachePlan as JCachePlan
from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer

STEPS = 10


@pytest.fixture(scope="module")
def engines():
    return tiny_engines()


@pytest.mark.parametrize("branch", [0, 1])
def test_unet_cache_split_matches_jax(engines, branch):
    """A full call's output and trunk features (``return_cache``) and a
    cached call's output (only the shallow branch on given features)."""
    jeng, params, teng = engines
    x, ctx = randn((2, 8, 8, 4), 1), randn((2, 77, 32), 2)
    ts = np.array([901.0, 21.0], np.float32)
    cache = randn((2,) + teng.unet.cache_shape(8, 8, branch), 3)
    assert teng.unet.cache_shape(8, 8, branch) == jeng.unet.cache_shape(8, 8, branch)
    apply = jax.jit(jeng.unet.apply, static_argnames=("return_cache", "cache_branch_id"))
    args = ({"params": params["unet"]}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    want_out, want_cache = apply(*args, return_cache=True, cache_branch_id=branch)
    want_cached = apply(*args, cache=jnp.asarray(cache), cache_branch_id=branch)
    with torch.inference_mode():
        out, feats = teng.unet(t(x), t(ts), t(ctx), return_cache=True, cache_branch_id=branch)
        cached = teng.unet(t(x), t(ts), t(ctx), t(cache), cache_branch_id=branch)
        plain = teng.unet(t(x), t(ts), t(ctx))
    # fp32 through ~20 convs/matmuls, as the plain UNet test.
    assert_close(out, want_out, 1e-4)
    assert_close(feats, want_cache, 1e-4)
    assert_close(cached, want_cached, 1e-4)
    assert torch.equal(out, plain)  # the full call is the plain forward
    with pytest.raises(ValueError, match="cache_branch_id 2 out of range"):
        teng.unet(t(x), t(ts), t(ctx), cache_branch_id=2)


@pytest.fixture(scope="module")
def prompts():
    tok = HashTokenizer(vocab_size=1000)
    return tok(["a cat", "a dog"]), tok(["", ""])


@pytest.fixture(scope="module")
def deep_cache_runs(engines, prompts):
    """The JAX tiny engine's DDIM runs with DeepCache (branch 0, intervals
    2 and 3), CFG 7.5, per-step x0 of sample 0."""
    jeng, params, _ = engines
    ids, neg_ids = prompts
    lat0 = randn((2, 8, 8, 4), 5)
    plan = JS.DDIMScheduler().build_plan(STEPS)
    emb, neg = jeng.encode_prompts(params, ids), jeng.encode_prompts(params, neg_ids)
    runs = {k: jeng.sample(params, plan, emb, neg, jax.random.PRNGKey(0), guidance_scale=7.5,
                           cache_plan=JCachePlan.every(STEPS, k, 0), latent_hw=(8, 8),
                           init_latents=jnp.asarray(lat0), collect_x0=True, x0_samples=1)
            for k in (2, 3)}
    return lat0, runs


@pytest.mark.parametrize("interval", [2, 3])
@pytest.mark.parametrize("microbatch", [None, 2])
def test_deep_cache_engine_matches_jax(engines, prompts, deep_cache_runs, interval, microbatch):
    """Full steps carry the trunk's features to the shallow steps; with
    ``microbatch`` the features chunk along the batch like the latents."""
    _, _, teng = engines
    ids, neg_ids = prompts
    lat0, runs = deep_cache_runs
    want = runs[interval]
    got = teng.sample(S.DDIMScheduler().build_plan(STEPS), teng.encode_prompts(ids),
                      teng.encode_prompts(neg_ids), guidance_scale=7.5,
                      cache_plan=CachePlan.every(STEPS, interval, 0), latent_hw=(8, 8),
                      init_latents=t(lat0), collect_x0=True, x0_samples=1, microbatch=microbatch)
    # fp32 over 10 CFG-amplified steps, as the DPM++ engine test.
    assert_close(got.latents, want.latents, 1e-3)
    assert_close(got.images, want.images, 1e-3)
    assert_close(got.x0_images, want.x0_images, 1e-3)
    assert got.nfe == want.nfe == STEPS


def test_cache_plan_is_checked(engines, prompts):
    _, _, teng = engines
    plan = S.DDIMScheduler().build_plan(4)
    emb = teng.encode_prompts(prompts[0])
    assert list(CachePlan.every(5, 2).full) == [True, False, True, False, True]
    with pytest.raises(ValueError, match="first step must compute"):
        teng.sample(plan, emb, None, cache_plan=CachePlan(np.array([False, True, True, True])),
                    latent_hw=(8, 8))
    with pytest.raises(ValueError, match="cache plan length"):
        teng.sample(plan, emb, None, cache_plan=CachePlan.every(3, 2), latent_hw=(8, 8))


def test_lcm_engine_matches_jax_with_its_noise(engines, prompts):
    """LCM (4 steps, guidance 0: no CFG batch) with the JAX engine's own
    step noise passed as ``step_noise``."""
    jeng, params, teng = engines
    ids, _ = prompts
    lat0, idx, key = randn((2, 8, 8, 4), 6), [5, 9], jax.random.PRNGKey(3)
    want = jeng.sample(params, JS.LCMScheduler().build_plan(4), jeng.encode_prompts(params, ids),
                       None, key, sample_indices=np.asarray(idx), guidance_scale=0.0,
                       latent_hw=(8, 8), init_latents=jnp.asarray(lat0))
    noise = jax_step_noise(key, idx, 4, (8, 8, 4))
    got = teng.sample(S.LCMScheduler().build_plan(4), teng.encode_prompts(ids), None,
                      sample_indices=idx, guidance_scale=0.0, latent_hw=(8, 8),
                      init_latents=t(lat0), step_noise=t(noise))
    assert_close(got.latents, want.latents, 1e-3)
    assert_close(got.images, want.images, 1e-3)
    with pytest.raises(ValueError, match="step_noise"):
        teng.sample(S.LCMScheduler().build_plan(4), teng.encode_prompts(ids), None,
                    guidance_scale=0.0, latent_hw=(8, 8), step_noise=t(noise[:3]))


def test_lcm_own_noise_depends_only_on_sample_index(engines, prompts):
    """Without ``step_noise`` sample i's noise at step k comes from (seed,
    i, k): the same image for sample 7 at either batch position."""
    _, _, teng = engines
    ids = prompts[0]
    plan = S.LCMScheduler().build_plan(4)
    a = teng.sample(plan, teng.encode_prompts(ids), None, seed=4, sample_indices=[3, 7],
                    guidance_scale=0.0, latent_hw=(8, 8))
    b = teng.sample(plan, teng.encode_prompts(ids[::-1].copy()), None, seed=4, sample_indices=[7, 3],
                    guidance_scale=0.0, latent_hw=(8, 8))
    assert_close(a.images[1], b.images[0], 1e-6)
    assert_close(a.images[0], b.images[1], 1e-6)
    n1, n2 = (per_sample_step_noise(4, [3, 7], k, (8, 8, 4)) for k in (1, 2))
    assert torch.equal(n1[1], per_sample_step_noise(4, [7], 1, (8, 8, 4))[0])
    assert not torch.equal(n1, n2)


# LoRA'd modules of the tiny UNet: 2-D (attention, feed-forward) and conv
# (a 3x3 resnet conv and a 1x1 transformer projection) LoRAs.
LORA_MODULES = (
    "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
    "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_out.0",
    "mid_block.attentions.0.transformer_blocks.0.ff.net.0.proj",
    "up_blocks.1.attentions.0.transformer_blocks.0.attn2.to_k",
    "down_blocks.0.resnets.0.conv1",
    "down_blocks.0.attentions.0.proj_in",
)


def _random_lora(layout, unet_sd, rank=4, seed=0):
    """A random LoRA in kohya or peft layout over LORA_MODULES (shapes from
    the UNet's own weights), with a stray key of each kind that matches
    nothing."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i, name in enumerate(LORA_MODULES):
        out_c, in_c, *k = unet_sd[f"{name}.weight"].shape
        down = rng.standard_normal((rank, in_c, *k)).astype(np.float32) * 0.1
        up = rng.standard_normal((out_c, rank) + ((1, 1) if k else ())).astype(np.float32) * 0.1
        if layout == "kohya":
            p = "lora_unet_" + name.replace(".", "_")
            sd.update({f"{p}.lora_down.weight": down, f"{p}.lora_up.weight": up})
            if i % 2:
                sd[f"{p}.alpha"] = np.float32(2.0)
        else:
            p = f"unet.{name}"
            sd.update({f"{p}.lora_A.weight": down, f"{p}.lora_B.weight": up})
            if i % 2:
                sd[f"{p}.alpha"] = np.float32(8.0)
    sd["lora_te_text_model_encoder_layers_0_mlp_fc1.lora_down.weight"] = np.ones((4, 4), np.float32)
    sd["lora_unet_no_such_module.lora_down.weight"] = np.ones((4, 4), np.float32)
    return sd


@pytest.mark.parametrize("layout", ["kohya", "peft"])
def test_merge_lora_matches_jax(engines, layout, tmp_path):
    jeng, params, _ = engines
    base = state_dicts_from_jax(params)
    lora = _random_lora(layout, base["unet"])
    want_tree = JW.merge_lora(params["unet"], lora, JW.unet_name_map(jeng.unet_config), 0.8)
    want = state_dicts_from_jax({**params, "unet": want_tree})["unet"]
    got, merged = merge_lora(base["unet"], {k: torch.as_tensor(v) for k, v in lora.items()}, 0.8)
    assert got.keys() == want.keys()
    for k in want:
        assert_close(got[k], want[k], 1e-6)  # fp32 products of O(0.1) factors
    names = sorted(LORA_MODULES)
    assert merged == names
    changed = sorted(k[: -len(".weight")] for k in got if not torch.equal(got[k], base["unet"][k]))
    assert changed == names

    # The pipeline stages the file and fuses it into its UNet.
    path = tmp_path / "lora.bin"
    torch.save({k: torch.as_tensor(v) for k, v in lora.items()}, path)
    pipe = StableDiffusionModel(tiny=True, dtype="float32", device="cpu", lora=str(path))
    pipe.engine.load_state_dicts(base)
    pipe.load_lora_weights(pipe.lora).fuse_lora(0.8)
    assert pipe.lora_merged == names
    sd = pipe.engine.unet.state_dict()
    assert all(torch.equal(sd[k], got[k]) for k in got)
    # A hub id with no local file stages nothing; fusing is then a no-op.
    pipe.load_lora_weights("latent-consistency/lcm-lora-sdv1-5").fuse_lora()
    assert all(torch.equal(v, sd[k]) for k, v in pipe.engine.unet.state_dict().items())
    with pytest.raises(KeyError, match="no LoRA tensors matched"):
        merge_lora(base["unet"], {"lora_unet_nothing.lora_down.weight": torch.ones(2, 2)})


def test_graphed_variants_keep_one_graph_per_variant(monkeypatch):
    """Each variant (non-tensor keyword arguments) keeps its own graph of
    its last signature; alternating variants capture once each, and a
    tuple output is copied out member by member."""
    graphs = []

    class Graph:
        def replay(self):
            pass

    def capture(self, args):
        graphs.append(Graph())
        static_in = [a.clone() for a in args]
        return graphs[-1], static_in, self.fn(*static_in)

    monkeypatch.setattr(GraphedCall, "_capture", capture)

    def fn(x, cache=None, full=False):
        return (x * 2, x + 1) if full else (x + cache if cache is not None else x * 3)

    call = GraphedVariants(fn)
    x, c = torch.ones(2), torch.full((2,), 5.0)
    for _ in range(3):
        out, feats = call(x, full=True)
        assert torch.equal(out, x * 2) and torch.equal(feats, x + 1)
        assert torch.equal(call(x, c), x + c)
    assert len(graphs) == 2 and call.captures == {(("full", True),): 1, (): 1}
    out2, _ = call(x, full=True)
    assert out2.data_ptr() != out.data_ptr()  # each replay returns a copy
    call(torch.ones(3), full=True)  # a new signature replaces that variant's graph only
    assert call.captures == {(("full", True),): 2, (): 1}
    call.clear()
    assert call.calls == {}
