"""The port's training (models/training.py, models/trainer.py) on the CPU
against the JAX package's.

The same weights and batches, made from a seed, go through both packages:
the PIT-BCE and AAM-softmax losses and their gradients (the ECAPA
BatchNorm running statistics' included, which both packages train) agree
at rtol 1e-4 / atol 1e-6. Adam is compared on its own, the same gradient
arrays fed to optax.adam and to the port's optimizer (updates within
1e-6): Adam's first step is sign(g) * lr, so a near-zero gradient that
differs in its last bit would flip a whole lr in a comparison of steps. A
JAX state carried into the port after 3 steps then continues in both
packages with losses within rtol 1e-4. Data-parallel: two gloo ranks on
uneven blocks equal one process."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _cfg import SMALL_ECAPA, SMALL_PYANNET
from _torch_threads import two_torch_threads  # noqa: F401
from pyannote_audio_speaker_diarization_cpp_tpu.models import ecapa as jecapa
from pyannote_audio_speaker_diarization_cpp_tpu.models import pyannet as jpyannet
from pyannote_audio_speaker_diarization_cpp_tpu.models import training as JT
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import layers as L
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import training as T
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import (
    flatten_pytree,
    train_state_from_jax,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import PyanNetConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.trainer import (
    Trainer,
    segmentation_trainer,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops.asp_cuda import (
    asp_pool_backward,
    asp_pool_plain,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.parallel import dryrun

RTOL, ATOL = 1e-4, 1e-6

PORT_PYANNET = PyanNetConfig(**dataclasses.asdict(SMALL_PYANNET))
PORT_ECAPA = EcapaConfig(**dataclasses.asdict(SMALL_ECAPA))
# the JAX checkpoint tests' slim model
TINY = dict(num_filters=16, conv_channels=12, lstm_hidden=16, lstm_layers=1, linear_hidden=16)


def _seg_batch(rng, cfg, batch=4, num_samples=8000):
    frames = jpyannet.pyannet_num_frames(num_samples, cfg)
    waveforms = (0.1 * rng.normal(size=(batch, num_samples))).astype(np.float32)
    labels = (rng.uniform(size=(batch, frames, cfg.num_classes)) > 0.5).astype(np.float32)
    return waveforms, labels


# the ASP conv's bias shifts every frame's score of a channel alike, which
# the softmax over frames cancels: its gradient is 0, and each package gives
# rounding noise (JAX's reached 1.9e-4 of the ASP conv weight's largest
# gradient, the port's 1e-5), each held below 1e-3 of it
ZERO_GRAD = "asp.conv.bias"


def _assert_grads_equal(port_params, jax_grads, leaf_scaled=False):
    """Every leaf's gradient against JAX's: elementwise at rtol 1e-4 / atol
    1e-6, or (``leaf_scaled``) within 1e-4 of the leaf's largest gradient."""
    want = flatten_pytree(jax.device_get(jax_grads))
    got = {k: v.grad.numpy() for k, v in flatten_pytree(port_params).items()}
    assert set(got) == set(want)
    for key in sorted(want):
        if key.endswith(ZERO_GRAD):
            bound = 1e-3 * float(np.abs(want[key.replace("bias", "weight")]).max())
            assert np.abs(got[key]).max() <= bound and np.abs(want[key]).max() <= bound, key
        elif leaf_scaled:
            atol = RTOL * float(np.abs(want[key]).max()) + ATOL
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=key)


def test_pit_bce_loss_and_grads_match_jax():
    params = jax.device_get(jpyannet.init_pyannet(jax.random.PRNGKey(0), SMALL_PYANNET))
    waveforms, labels = _seg_batch(np.random.default_rng(0), SMALL_PYANNET)
    want, grads = jax.value_and_grad(JT.pit_bce_loss)(
        params, jnp.asarray(waveforms), jnp.asarray(labels), SMALL_PYANNET
    )
    state = T.init_train_state(params, device="cpu")
    loss = T.pit_bce_loss(
        state.params, torch.from_numpy(waveforms), torch.from_numpy(labels), PORT_PYANNET
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    _assert_grads_equal(state.params, grads)


def _ecapa_problem(rng, moved: bool, num_classes=5, batch=4, frames=60):
    """JAX-initialised ECAPA weights (``moved``: every BatchNorm's running
    statistics moved off their init, mean 0 and var 1), an AAM head, and a
    batch with partial lengths."""
    params = jax.device_get(jecapa.init_ecapa(jax.random.PRNGKey(1), SMALL_ECAPA))

    def stats(node):
        if isinstance(node, dict):
            if "running_var" in node and moved:
                n = node["running_var"].shape
                node = dict(
                    node,
                    running_mean=(0.1 * rng.normal(size=n)).astype(np.float32),
                    running_var=rng.uniform(0.5, 1.5, size=n).astype(np.float32),
                )
            return {k: stats(v) for k, v in node.items()}
        if isinstance(node, list):
            return [stats(v) for v in node]
        return node

    params = stats(params)
    head = {"weight": (0.01 * rng.normal(size=(num_classes, SMALL_ECAPA.emb_dim))).astype(np.float32)}
    feats = rng.normal(size=(batch, frames, SMALL_ECAPA.in_channels)).astype(np.float32)
    lengths = np.array([1.0, 0.8, 0.55, 1.0], np.float32)[:batch]
    labels = np.arange(batch) % num_classes
    return params, head, feats, lengths, labels


@jax.jit
def _jax_aam_value_and_grad(both, feats, lengths, labels):
    def loss_fn(both):
        return JT.ecapa_classification_loss(
            both["params"], both["head"], feats, lengths, labels, SMALL_ECAPA
        )

    return jax.value_and_grad(loss_fn)(both)


@pytest.mark.parametrize("stats", ["init", "moved"])
def test_aam_loss_and_grads_match_jax_batchnorm_statistics_included(stats):
    """At the JAX init statistics every gradient agrees elementwise at
    rtol 1e-4 / atol 1e-6. With the statistics moved, the two packages'
    embeddings differ by float32 rounding (~2e-5 of their scale: the
    BatchNorm products no longer round alike), which the gradients of an
    untrained model amplify where a sum over the batch cancels (its
    embeddings nearly coincide): there each leaf agrees within 1e-4 of its
    largest gradient."""
    moved = stats == "moved"
    params, head, feats, lengths, labels = _ecapa_problem(np.random.default_rng(1), moved)
    want, grads = _jax_aam_value_and_grad(
        {"params": params, "head": head},
        jnp.asarray(feats), jnp.asarray(lengths), jnp.asarray(labels),
    )
    state = T.init_train_state({"params": params, "head": head}, device="cpu")
    loss = T.ecapa_classification_loss(
        state.params["params"], state.params["head"], torch.from_numpy(feats),
        torch.from_numpy(lengths), torch.from_numpy(labels), PORT_ECAPA,
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    _assert_grads_equal(state.params, grads, leaf_scaled=moved)
    bn = state.params["params"]["block0"]["bn"]
    assert float(bn["running_mean"].grad.abs().max()) > 0
    assert float(bn["running_var"].grad.abs().max()) > 0


def test_adam_updates_match_optax():
    rng = np.random.default_rng(2)
    params = {
        "a": rng.normal(size=(3, 4)).astype(np.float32),
        "b": [rng.normal(size=(5,)).astype(np.float32), {"c": rng.normal(size=(2, 2)).astype(np.float32)}],
    }
    opt = optax.adam(1e-3)
    jparams, jstate = params, opt.init(params)
    state = T.init_train_state(params, device="cpu")
    leaves = T.tree_leaves(state.params)
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: (rng.normal(size=x.shape) * 10.0 ** rng.integers(-8, 1)).astype(np.float32),
            params,
        )
        updates, jstate = opt.update(grads, jstate, jparams)
        jparams = jax.device_get(optax.apply_updates(jparams, updates))
        for p, g in zip(leaves, T.tree_leaves(grads)):
            p.grad = torch.from_numpy(g)
        state.optimizer.step()
        for p, want in zip(leaves, T.tree_leaves(jparams)):
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=1e-6)
    # the optimizer's state in the JAX layout: optax's count, mu and nu
    _, (count, mu, nu), _ = T.train_state_tree(state)
    adam = jstate[0]
    assert int(count) == int(adam.count) == 3
    for got, want in zip(T.tree_leaves(mu) + T.tree_leaves(nu), T.tree_leaves(jax.device_get(adam.mu)) + T.tree_leaves(jax.device_get(adam.nu))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)


def test_carried_jax_state_continues_in_both_packages():
    jcfg = jpyannet.PyanNetConfig(**TINY)
    rng = np.random.default_rng(3)
    batches = [_seg_batch(rng, jcfg, batch=4, num_samples=4000) for _ in range(5)]
    opt = optax.adam(1e-3)
    params = jpyannet.init_pyannet(jax.random.PRNGKey(0), jcfg)
    jstate = JT.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(JT.make_segmentation_train_step(opt, jcfg))
    for b in batches[:3]:
        jstate, _ = step(jstate, *map(jnp.asarray, b))
    host = jax.device_get(jstate)
    adam = host.opt_state[0]
    port = train_state_from_jax(
        host.params, adam.count, adam.mu, adam.nu, host.step, device="cpu"
    )
    assert port.step == 3
    port_step = T.make_segmentation_train_step(PyanNetConfig(**TINY))
    for b in batches[3:]:
        jstate, want = step(jstate, *map(jnp.asarray, b))
        port, got = port_step(port, *b)
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert port.step == int(jstate.step) == 5


def test_train_states_default_to_the_card(monkeypatch):
    """A state made without a device goes to the card, as the pipeline and
    ``Trainer`` do: without one it refuses rather than train on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {"w": np.ones(3, np.float32)}
    zeros = {"w": np.zeros(3, np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_train_state(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_state_from_jax(params, np.int32(0), zeros, zeros, np.int32(0))
    assert T.init_train_state(params, device="cpu").params["w"].device.type == "cpu"


def test_segmentation_trainer_loss_decreases():
    cfg = PyanNetConfig(num_filters=8, conv_channels=6, lstm_hidden=8, lstm_layers=1, linear_hidden=8)
    trainer = segmentation_trainer(
        T.tree_map(np.asarray, _pyannet_params(cfg)),
        cfg,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=3e-3),
        device="cpu",
    )
    rng = np.random.default_rng(0)
    wav, labels = _seg_batch(rng, cfg, batch=8, num_samples=4000)
    labels = (rng.uniform(size=labels.shape) > 0.7).astype(np.float32)
    losses = trainer.fit(iter([(wav, labels)] * 30), log_every=0)
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()
    assert trainer.state.step == 30


def _pyannet_params(cfg):
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import pyannet_tree
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import PyanNet

    return pyannet_tree(PyanNet(cfg))


def test_embedding_trainer_steps_and_moves_the_batchnorm_statistics():
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import ecapa_tree
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaTDNN

    cfg = EcapaConfig(
        in_channels=8, channels=(16, 16, 16, 16, 48), attention_channels=8,
        res2net_scale=4, se_channels=4, emb_dim=12,
    )
    both = {
        "params": ecapa_tree(EcapaTDNN(cfg)),
        "head": T.init_aam_head(torch.Generator().manual_seed(0), 12, num_classes=5),
    }
    trainer = Trainer(both, lambda mesh: T.make_embedding_train_step(cfg, mesh), device="cpu")
    before = trainer.params["params"]["mfa"]["bn"]["running_var"].detach().clone()
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(4, 20, 8)).astype(np.float32)
    losses = [trainer.step(feats, np.ones(4, np.float32), np.arange(4)) for _ in range(2)]
    assert np.isfinite(losses).all() and trainer.state.step == 2
    assert not torch.equal(trainer.params["params"]["mfa"]["bn"]["running_var"], before)
    # every parameter got a gradient; the first conv's (the deepest path,
    # through every block and the ASP tail) is nonzero
    assert all(p.grad is not None for p in T.tree_leaves(trainer.params))
    assert float(trainer.params["params"]["block0"]["conv"]["weight"].grad.abs().max()) > 0


def test_lstm_dropout_refused_in_training():
    lstm = torch.nn.LSTM(4, 4, num_layers=2, dropout=0.5)
    with pytest.raises(ValueError, match="dropout"):
        T.prepare_for_training(torch.nn.Sequential(lstm))
    model = T.prepare_for_training(torch.nn.Sequential(torch.nn.LSTM(4, 4), L.BatchNorm1d(4)))
    assert model[0].training and not model[1].training


def test_batchnorm_with_trained_statistics_is_the_inference_arithmetic():
    bn = L.BatchNorm1d(6).eval()
    with torch.no_grad():
        bn.running_mean.normal_()
        bn.running_var.uniform_(0.5, 2.0)
        bn.weight.normal_()
    x = torch.randn(3, 6, 7)
    want = bn(x)
    bn.running_mean.requires_grad_()
    bn.running_var.requires_grad_()
    got = bn(x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    got.sum().backward()
    assert bn.running_var.grad is not None
    torch.testing.assert_close(
        L.batchnorm1d_nlc(x.transpose(1, 2), bn), want.transpose(1, 2), rtol=1e-6, atol=1e-6
    )


@pytest.mark.parametrize("case", ["lengths", "one_frame"])
def test_asp_backward_matches_autograd_through_the_plain_version(case):
    """The closed form the CUDA kernel's autograd node runs, here against
    autograd through asp_pool_plain on the CPU."""
    gen = torch.Generator().manual_seed(4)
    B, C, A, T_ = 3, 40, 8, 50
    x = torch.randn((B, C, T_), generator=gen, requires_grad=True)
    a = torch.tanh(torch.randn((B, A, T_), generator=gen)).requires_grad_()
    w = (0.3 * torch.randn((C, A), generator=gen)).requires_grad_()
    b = (0.1 * torch.randn((C,), generator=gen)).requires_grad_()
    ends = torch.tensor([50, 30, 1 if case == "one_frame" else 10])
    mask = (torch.arange(T_)[None, :] < ends[:, None]).float()
    mean, std = asp_pool_plain(x, a, w, b, mask)
    g_mean, g_std = torch.randn(mean.shape, generator=gen), torch.randn(std.shape, generator=gen)
    want = torch.autograd.grad((mean * g_mean + std * g_std).sum(), (x, a, w, b))
    got = asp_pool_backward(x.detach(), a.detach(), w.detach(), b.detach(), mask, 1e-12, g_mean, g_std)
    for name, g, h in zip(("x", "a_tanh", "w", "bias"), got, want):
        torch.testing.assert_close(g, h, rtol=1e-4, atol=1e-6, msg=name)


def test_data_parallel_two_gloo_ranks_uneven_equal_one_process():
    reports = dryrun.spawn(dryrun.train_case, 2, 5, device="cpu", threads=2, timeout=300)
    assert [r["rows"] for r in reports] == [3, 2]
    for r in reports:
        assert r["grads_within"] and r["step"] == 1
        np.testing.assert_allclose(r["loss"], r["loss_single"], rtol=RTOL)
    assert reports[0]["loss"] == reports[1]["loss"]
    assert reports[0]["params_digest"] == reports[1]["params_digest"]
