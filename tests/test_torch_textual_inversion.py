"""The port's textual inversion against the JAX package's (tiny configs,
fp32, CPU, JAX trees from ``jax.eval_shape``): one step's loss and the
placeholder rows' gradient, 3-step runs (epsilon; v-prediction with
min-SNR, warmup and EMA), only the placeholder rows moving (the token
table, the rest of the text tower and the UNet untouched), the order of
the placeholders with ``init_ids``, the ``save_embeddings`` artifact and
the constructor's errors.  Both sides take the JAX step's draws (t and
noise from ``split(fold_in(key, step))``).

Tolerances, as ``test_torch_training.py``'s: one step 1e-6 + 1e-4·|ref|
(fp32 through the text tower and the UNet, summation order apart); runs
within Adam's sign-flip bound (``torch_parity.assert_adam_close``), losses
and grad norms a step within 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_adam_close, assert_close, randn, step_lrs, t, tiny_engines
from sonicdiffusionbayeslab_torch.training import textual_inversion as TTI
from sonicdiffusionbayeslab_torch.training import trainer as TT
from sonicdiffusionbayeslab_tpu.training import textual_inversion as JTI
from sonicdiffusionbayeslab_tpu.training import trainer as JT

KEY = jax.random.PRNGKey(5)
STEP_TOL = (1e-6, 1e-4)
PLACEHOLDERS, INIT = [997, 998], [10, 11]


def jax_draws(step, shape, T=1000):
    """The JAX TI step's draws at ``step``: (t [B], noise)."""
    k_t, k_noise = jax.random.split(jax.random.fold_in(KEY, step))
    return (np.array(jax.random.randint(k_t, (shape[0],), 0, T)),
            np.array(jax.random.normal(k_noise, shape, jnp.float32)))


@pytest.fixture(scope="module")
def batch():
    ids = np.full((2, 77), 5, np.int32)
    ids[:, 3], ids[:, 4] = 997, 998
    ids[1, 6] = 998
    return randn((2, 8, 8, 4), 1), ids


def _jax_loss(jtr, params, lat, ids, tsteps, noise):
    """The JAX TI step's loss_fn as a function of the rows."""
    cfg, eng = jtr.config, jtr.engine
    ac = jnp.asarray(jtr.schedule.alphas_cumprod, jnp.float32)
    a = ac[tsteps][:, None, None, None]
    noisy = jnp.sqrt(a) * lat + jnp.sqrt(1.0 - a) * noise

    def loss(rows):
        table = jnp.asarray(params["text"]["token_embedding"]["embedding"], jnp.float32)
        text = dict(params["text"], token_embedding={
            "embedding": table.at[jnp.asarray(jtr.placeholder_ids)].set(rows)})
        ctx = eng.text.apply({"params": text}, ids)["last_hidden_state"]
        pred = eng.unet.apply({"params": params["unet"]}, noisy, tsteps.astype(jnp.float32), ctx)
        return jnp.mean(jnp.mean((pred - noise) ** 2, axis=(1, 2, 3)))

    assert cfg.prediction_type == "epsilon" and cfg.snr_gamma is None
    return jax.jit(jax.value_and_grad(loss))


def test_one_step_loss_and_row_gradients_match_jax(batch):
    """At rows seeded from other tokens: the loss and the two rows'
    gradient (through the tower's causal attention and the UNet's
    cross-attentions' K and V); nothing else gets a gradient."""
    jeng, params, teng = tiny_engines()
    lat, ids = batch
    jtr = JTI.TextualInversionTrainer(jeng, PLACEHOLDERS, JT.TrainConfig())
    rows = jtr.init_state(params, init_ids=INIT).trainable
    tsteps, noise = jax_draws(0, lat.shape)
    want_loss, want_grad = _jax_loss(jtr, params, jnp.asarray(lat), jnp.asarray(ids),
                                     jnp.asarray(tsteps), jnp.asarray(noise))(rows)
    tr = TTI.TextualInversionTrainer(teng, PLACEHOLDERS, TT.TrainConfig())
    state = tr.init_state(init_ids=INIT)
    assert torch.equal(state.trainable.detach(), t(rows))
    loss, grad = tr.value_and_grad(state, t(lat), ids, timesteps=torch.from_numpy(tsteps),
                                   noise=t(noise))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert grad.shape == (2, 32)
    assert_close(grad, np.asarray(want_grad), *STEP_TOL)
    assert all(g.abs().max() > 0 for g in grad)
    assert not any(p.requires_grad for m in teng.modules() for p in m.parameters())


def _run(batch, cfg_kw, steps=3):
    jeng, params, teng = tiny_engines()
    lat, ids = batch
    jtr = JTI.TextualInversionTrainer(jeng, PLACEHOLDERS, JT.TrainConfig(donate=False, **cfg_kw))
    tr = TTI.TextualInversionTrainer(teng, PLACEHOLDERS, TT.TrainConfig(**cfg_kw))
    js, ts = jtr.init_state(params, init_ids=INIT), tr.init_state(init_ids=INIT)
    before = {k: v.clone() for m in teng.modules() for k, v in m.state_dict().items()}
    for s in range(steps):
        js, jm_ = jtr.train_step(js, params, jnp.asarray(lat), ids, KEY)
        tsteps, noise = jax_draws(s, lat.shape)
        ts, tm = tr.train_step(ts, t(lat), ids, timesteps=torch.from_numpy(tsteps),
                               noise=t(noise))
        np.testing.assert_allclose(float(tm["loss"]), float(jm_["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm_["grad_norm"]), rtol=1e-5)
    after = {k: v for m in teng.modules() for k, v in m.state_dict().items()}
    assert all(torch.equal(v, before[k]) for k, v in after.items())
    return (jtr, js), (tr, ts)


@pytest.mark.parametrize("cfg_kw", [
    dict(learning_rate=1e-3),
    dict(learning_rate=1e-3, prediction_type="v_prediction", snr_gamma=5.0, warmup_steps=2,
         ema_decay=0.9)], ids=["epsilon", "v_min_snr_warmup_ema"])
def test_three_steps_match_jax_and_only_the_rows_move(batch, cfg_kw):
    (jtr, js), (tr, ts) = _run(batch, cfg_kw)
    lrs = step_lrs(cfg_kw["learning_rate"], 3, cfg_kw.get("warmup_steps", 0))
    assert_adam_close(ts.trainable.detach(), np.asarray(js.trainable), lrs)
    if cfg_kw.get("ema_decay"):
        assert_adam_close(ts.ema, np.asarray(js.ema), lrs)
        _, params, _ = tiny_engines()
        jparams = {"text": jax.tree.map(jnp.asarray, params["text"])}
        want = np.asarray(jtr.text_params(js, jparams, use_ema=True)["token_embedding"]
                          ["embedding"])[PLACEHOLDERS]
        assert_adam_close(tr.text_params(ts, use_ema=True)[TTI.TOKEN_TABLE][PLACEHOLDERS],
                          want, lrs)
    else:
        assert ts.ema is None and js.ema is None
    table = tr.engine.text.state_dict()[TTI.TOKEN_TABLE]
    sd = tr.text_params(ts)
    moved = torch.nonzero((sd[TTI.TOKEN_TABLE] != table).any(dim=1)).flatten().tolist()
    assert moved == PLACEHOLDERS
    assert set(sd) == set(tr.engine.text.state_dict())
    assert all(torch.equal(v, tr.engine.text.state_dict()[k]) for k, v in sd.items()
               if k != TTI.TOKEN_TABLE)
    assert ts.step == 3


def test_placeholder_order_is_kept_with_init_ids():
    jeng, params, teng = tiny_engines()
    table = np.asarray(params["text"]["token_embedding"]["embedding"], np.float32)
    j = JTI.TextualInversionTrainer(jeng, [700, 300, 700])
    tr = TTI.TextualInversionTrainer(teng, [700, 300, 700])
    assert list(tr.placeholder_ids) == list(j.placeholder_ids) == [700, 300]
    rows = tr.init_state(init_ids=INIT).trainable.detach()
    assert np.array_equal(rows.numpy(), table[INIT])
    assert np.array_equal(rows.numpy(), np.asarray(j.init_state(params, init_ids=INIT).trainable))
    own = tr.init_state().trainable.detach()
    assert np.array_equal(own.numpy(), table[[700, 300]])


def test_save_embeddings_equals_jax(tmp_path):
    jeng, params, teng = tiny_engines()
    j = JTI.TextualInversionTrainer(jeng, [42, 7])
    tr = TTI.TextualInversionTrainer(teng, [42, 7])
    j.save_embeddings(j.init_state(params, init_ids=INIT), tmp_path / "jax.npz")
    tr.save_embeddings(tr.init_state(init_ids=INIT), tmp_path / "port.npz")
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert got.files == want.files == ["ids", "embeddings"]
    for k in want.files:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("ids,kw", [
    ([], {}), ([10_000_000], {}), ([1, 2], dict(prediction_type="sample"))])
def test_constructor_errors_are_jax_s(ids, kw):
    jeng, _, teng = tiny_engines()
    with pytest.raises(ValueError) as jerr:
        JTI.TextualInversionTrainer(jeng, ids, JT.TrainConfig(**kw))
    with pytest.raises(ValueError) as terr:
        TTI.TextualInversionTrainer(teng, ids, TT.TrainConfig(**kw))
    assert str(terr.value) == str(jerr.value)


def test_init_ids_of_another_length_raise_as_jax():
    jeng, params, teng = tiny_engines()
    with pytest.raises(ValueError) as jerr:
        JTI.TextualInversionTrainer(jeng, [1, 2]).init_state(params, init_ids=[5])
    with pytest.raises(ValueError) as terr:
        TTI.TextualInversionTrainer(teng, [1, 2]).init_state(init_ids=[5])
    assert str(terr.value) == str(jerr.value) == "init_ids length != placeholder count"
