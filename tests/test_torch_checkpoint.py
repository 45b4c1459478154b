"""The port's checkpoints (utils/checkpoint.py) on the CPU: the JAX
package's checkpoint cases against the port, then the two packages on one
another's files. A port TrainState flattens to the JAX TrainState's leaf
order (params in sorted-key order, Adam's count, mu, nu, then the step), so
a checkpoint written by either trainer resumes in the other; a resumed
port run continues bit-identically."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import two_torch_threads  # noqa: F401
from pyannote_audio_speaker_diarization_cpp_tpu.models import pyannet as jpyannet
from pyannote_audio_speaker_diarization_cpp_tpu.models.trainer import (
    segmentation_trainer as jax_segmentation_trainer,
)
from pyannote_audio_speaker_diarization_cpp_tpu.utils import checkpoint as jckpt
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models import training as T
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.convert import pyannet_tree
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import (
    PyanNet,
    PyanNetConfig,
    pyannet_num_frames,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.trainer import segmentation_trainer
from pyannote_audio_speaker_diarization_cpp_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    restore_pytree,
    save_pytree,
    tree_flatten_with_path,
    tree_leaves,
)

TINY = PyanNetConfig(
    num_filters=16, conv_channels=12, lstm_hidden=16, lstm_layers=1, linear_hidden=16
)
JAX_TINY = jpyannet.PyanNetConfig(**dataclasses.asdict(TINY))


def _batch(rng, cfg=TINY, batch=4, num_samples=2000):
    frames = pyannet_num_frames(num_samples, cfg)
    waveforms = rng.normal(size=(batch, num_samples)).astype(np.float32)
    labels = (rng.uniform(size=(batch, frames, cfg.num_classes)) > 0.5).astype(np.float32)
    return waveforms, labels


def _trainer(seed=0):
    return segmentation_trainer(pyannet_tree(PyanNet(TINY, torch.Generator().manual_seed(seed))), TINY, device="cpu")


def _equal(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def test_pytree_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": [torch.ones((4,), dtype=torch.bfloat16) * 1.5, {"c": torch.tensor(7, dtype=torch.int32)}],
        "t": (np.zeros((1, 1), np.float32), np.float64(2.5)),
    }
    path = str(tmp_path / "tree.npz")
    save_pytree(path, tree)
    out = restore_pytree(path, tree)
    for want, got in zip(tree_leaves(tree), tree_leaves(out)):
        assert type(want) is type(got) or isinstance(want, np.generic)
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype
            assert torch.equal(got, want)
        else:
            _equal(want, got)


def test_restore_rejects_shape_mismatch(tmp_path):
    path = str(tmp_path / "tree.npz")
    save_pytree(path, {"w": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="shape"):
        restore_pytree(path, {"w": torch.zeros((3, 2))})


def test_restore_rejects_structure_mismatch(tmp_path):
    path = str(tmp_path / "tree.npz")
    save_pytree(path, {"w": torch.zeros((2,)), "b": torch.zeros((2,))})
    with pytest.raises(ValueError, match="leaves"):
        restore_pytree(path, {"w": torch.zeros((2,))})


def test_restore_casts_to_the_template_dtype(tmp_path):
    path = str(tmp_path / "tree.npz")
    save_pytree(path, {"w": np.arange(3, dtype=np.float64)})
    out = restore_pytree(path, {"w": torch.zeros(3, dtype=torch.float32)})
    assert out["w"].dtype == torch.float32
    assert torch.equal(out["w"], torch.arange(3, dtype=torch.float32))


def test_manager_latest_and_keep(tmp_path):
    manager = CheckpointManager(str(tmp_path / "ckpts"), keep=2)
    for step in (1, 2, 3):
        manager.save(step, {"x": torch.full((2,), float(step))})
    assert manager.latest_step() == 3
    restored, step = manager.restore({"x": torch.zeros((2,))})
    assert step == 3
    assert restored["x"].tolist() == [3.0, 3.0]
    with pytest.raises(FileNotFoundError):  # keep=2 pruned step 1
        manager.restore({"x": torch.zeros((2,))}, step=1)


def test_bfloat16_files_read_in_both_packages(tmp_path):
    values = np.array([1.5, -2.25, 3.0e-3, 7.0], np.float32)
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_pytree(port_path, {"w": torch.from_numpy(values).to(torch.bfloat16)})
    jckpt.save_pytree(jax_path, {"w": jnp.asarray(values, jnp.bfloat16)})
    from_jax = restore_pytree(jax_path, {"w": torch.zeros(4, dtype=torch.bfloat16)})["w"]
    from_port = jckpt.restore_pytree(port_path, {"w": jnp.zeros(4, jnp.bfloat16)})["w"]
    want = torch.from_numpy(values).to(torch.bfloat16)
    assert torch.equal(from_jax, want)
    np.testing.assert_array_equal(np.asarray(from_port, np.float32), want.float().numpy())


def test_trainer_resume_is_bit_identical(tmp_path):
    rng = np.random.default_rng(0)
    batches = [_batch(rng) for _ in range(4)]
    ref = _trainer()
    ref_losses = [ref.step(*b) for b in batches]
    first = _trainer()
    first_losses = [first.step(*b) for b in batches[:2]]
    ckpt_dir = str(tmp_path / "run")
    first.save_checkpoint(ckpt_dir)
    fresh = _trainer(seed=99)
    assert fresh.restore_checkpoint(ckpt_dir) == 2
    assert fresh.state.step == 2
    resumed_losses = [fresh.step(*b) for b in batches[2:]]
    assert first_losses + resumed_losses == ref_losses
    for want, got in zip(tree_leaves(T.train_state_tree(ref.state)), tree_leaves(T.train_state_tree(fresh.state))):
        _equal(want, got)


def test_fit_writes_checkpoints(tmp_path):
    rng = np.random.default_rng(1)
    trainer = _trainer()
    ckpt_dir = str(tmp_path / "fit")
    trainer.fit([_batch(rng) for _ in range(3)], log_every=0, checkpoint_dir=ckpt_dir, checkpoint_every=2)
    manager = CheckpointManager(ckpt_dir)
    assert manager.latest_step() == 3  # final save at end of fit
    assert sorted(manager._steps()) == [2, 3]
    _, step = manager.restore(T.train_state_tree(trainer.state))
    assert step == 3


def _jax_keys(tree):
    return [jax.tree_util.keystr(path) for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX trainer after 2 steps and its checkpoint; the next 2 batches."""
    rng = np.random.default_rng(2)
    batches = [_batch(rng) for _ in range(4)]
    trainer = jax_segmentation_trainer(jpyannet.init_pyannet(jax.random.PRNGKey(0), JAX_TINY), cfg=JAX_TINY)
    for b in batches[:2]:
        trainer.step(*b)
    ckpt_dir = str(tmp_path_factory.mktemp("jax_run"))
    trainer.save_checkpoint(ckpt_dir)
    return trainer, ckpt_dir, batches[2:]


def test_train_state_leaf_order_is_the_jax_train_states(jax_run):
    trainer, _, _ = jax_run
    port = _trainer().state
    jax_leaves = jax.tree_util.tree_leaves(trainer.state)
    port_leaves = tree_leaves(T.train_state_tree(port))
    assert len(port_leaves) == len(jax_leaves)
    for want, got in zip(jax_leaves, port_leaves):
        assert tuple(np.shape(want)) == tuple(got.shape)
    # the params' paths in the same order
    n = len(tree_leaves(port.params))
    port_paths = [path for path, _ in tree_flatten_with_path(port.params)]
    assert port_paths == _jax_keys(trainer.state.params)[:n]


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    trainer, ckpt_dir, batches = jax_run
    port = _trainer(seed=5)
    assert port.restore_checkpoint(ckpt_dir) == 2
    state_leaves = tree_leaves(T.train_state_tree(port.state))
    for want, got in zip(jax.tree_util.tree_leaves(jax.device_get(trainer.state)), state_leaves):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # the next steps continue the JAX run (its trainer steps on a copy)
    jax_next = jax_segmentation_trainer(trainer.state.params, cfg=JAX_TINY)
    jax_next.state = trainer.state
    for b in batches:
        np.testing.assert_allclose(port.step(*b), jax_next.step(*b), rtol=1e-4)


def test_port_checkpoint_restores_in_jax(jax_run, tmp_path):
    trainer, _, _ = jax_run
    port = _trainer(seed=6)
    rng = np.random.default_rng(3)
    for _ in range(2):
        port.step(*_batch(rng))
    ckpt_dir = str(tmp_path / "port_run")
    port.save_checkpoint(ckpt_dir)
    restored, step = jckpt.CheckpointManager(ckpt_dir).restore(trainer.state)
    assert step == 2 and int(restored.step) == 2
    for want, got in zip(tree_leaves(T.train_state_tree(port.state)), jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
