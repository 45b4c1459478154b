"""The port does everything the JAX package does, held by its source.

For every module of the JAX package, the port's module at the same path
must define every public top-level function and class, every public method
(``__init__`` and ``__call__`` included), property, class attribute and
dataclass or NamedTuple field of each class, and every parameter name of
each function and method; an ``__init__.py`` must also re-export every
public name the JAX one does. Names are read from the source with ``ast``:
neither package is imported.

What the port leaves out on purpose is listed in ``ALLOWED``, one line of
reason an entry, and holds JAX idioms only (Pallas, the functional layer
API, jit and XLA formulations, the JAX PRNG, optax, ``jax.sharding``).
A gap not on the list fails its module's case; an entry that is no longer
a gap fails ``test_allowlist_has_no_stale_entry``.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "pyannote_audio_speaker_diarization_cpp_tpu")
PORT_PKG = os.path.join(REPO, "pyannote_audio_speaker_diarization_cpp_tpu_torch")

# Pallas modules -> the port's hand-written CUDA kernel and its wrapper
REPLACED_MODULES = {
    "ops/asp_pallas.py": ("csrc/asp.cu", "ops/asp_cuda.py"),
    "ops/frontend_pallas.py": ("csrc/frontend.cu", "ops/frontend_cuda.py"),
    "ops/pack_pallas.py": ("csrc/pack.cu", "ops/pack_cuda.py"),
}

_FUNCTIONAL = "the functional layer API (params dicts): the port's nn.Module does this"
_NN_PARAMS = "a params dict: the port passes the module's own tensors"
_PRECISION = "jax.lax.Precision: the port sets TF32 with precision_scope"
_XLA_LSTM = "a choice between XLA scan formulations of the LSTM: cuDNN runs it"
_SHARDING = "jax.sharding signature: the port's DataMesh over a torch.distributed group"
_OPTAX = "optax: the port takes a torch.optim factory"
_PRNG = "the JAX PRNG: the port draws from a torch.Generator"

ALLOWED = {
    "ops/aggregate.py: aggregate_compiled": "jit-compiled aggregation; the port calls aggregate",
    "ops/frontend.py: num_stft_frames": "a static shape for jit; the kernel computes it",
    "ops/masks.py: interpolate_nearest": "XLA gather formulation of the pack's frame map",
    "ops/masks.py: left_pack": "XLA formulation of the pack, replaced by csrc/pack.cu",
    "ops/masks.py: pack_frame_runs": "XLA formulation of the pack, replaced by csrc/pack.cu",
    "ops/masks.py: pack_and_lengths(backend)": "a choice of XLA or Pallas pack: one kernel",
    "ops/windows.py: chunk_waveform": "XLA gather of the chunks; the port takes strided views",
    "ops/windows.py: chunk_starts_seconds": "a jit helper of chunk_waveform",
    "pipelines/diarization.py: SpeakerDiarizationPipeline.__init__(frontend_backend)": (
        "a choice of XLA or Pallas front-end: one kernel (ROADMAP, not faults)"
    ),
    "parallel/longform.py: JaxHostComm": "jax.experimental.multihost_utils transport",
    "parallel/mesh.py: make_mesh(devices)": _SHARDING,
    "parallel/mesh.py: make_mesh(axis)": _SHARDING,
    "parallel/mesh.py: batch_spec(ndim)": _SHARDING,
    "parallel/mesh.py: batch_spec(axis)": _SHARDING,
    "parallel/sharding.py: all_gather_embeddings(embeddings)": _SHARDING,
    "models/convert.py: random_params": _PRNG,
    "models/ecapa.py: init_ecapa": _FUNCTIONAL,
    "models/ecapa.py: ecapa_forward": _FUNCTIONAL,
    "models/layers.py: init_conv1d": _FUNCTIONAL,
    "models/layers.py: init_linear": _FUNCTIONAL,
    "models/layers.py: init_batchnorm": _FUNCTIONAL,
    "models/layers.py: init_instancenorm": _FUNCTIONAL,
    "models/layers.py: init_lstm": _FUNCTIONAL,
    "models/layers.py: conv1d": _FUNCTIONAL,
    "models/layers.py: linear": _FUNCTIONAL,
    "models/layers.py: batchnorm1d": _FUNCTIONAL,
    "models/layers.py: max_pool1d": _FUNCTIONAL,
    "models/layers.py: lstm_cell_scan": _FUNCTIONAL,
    "models/layers.py: bilstm_layer_fused": _FUNCTIONAL,
    "models/layers.py: conv1d_nhc(p)": _NN_PARAMS,
    "models/layers.py: conv1d_nhc(precision)": _PRECISION,
    "models/layers.py: batchnorm1d_nlc(p)": _NN_PARAMS,
    "models/layers.py: batchnorm1d_nlc(eps)": "the module's own eps",
    "models/layers.py: conv1d_gemm(p)": _NN_PARAMS,
    "models/layers.py: conv1d_gemm(precision)": _PRECISION,
    "models/layers.py: instancenorm1d(p)": _NN_PARAMS,
    "models/layers.py: bilstm_stack(precision)": _PRECISION,
    "models/layers.py: bilstm_stack(fused)": _XLA_LSTM,
    "models/layers.py: bilstm_stack(unroll)": _XLA_LSTM,
    "models/pyannet.py: init_pyannet": _FUNCTIONAL,
    "models/pyannet.py: sinc_filters": "the port's SincFilters module computes the bank",
    "models/pyannet.py: sincnet_forward": _FUNCTIONAL,
    "models/pyannet.py: pyannet_forward": _FUNCTIONAL,
    "models/pyannet.py: pyannet_head_forward": _FUNCTIONAL,
    "models/training.py: TrainState.opt_state": _OPTAX + " (TrainState.optimizer holds it)",
    "models/training.py: make_segmentation_train_step(optimizer)": _OPTAX,
    "models/training.py: make_embedding_train_step(optimizer)": _OPTAX,
    "models/training.py: init_aam_head(key)": _PRNG,
    "utils/timing.py: xprof_trace": "the XLA profiler; the port has profiler_trace",
}

# never to be allowed: the pipeline's profile mode and its spans
REQUIRED = ("profile", "embedding", "total")


def _modules():
    for root, _, files in os.walk(JAX_PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.relpath(os.path.join(root, name), JAX_PKG)


JAX_MODULES = sorted(_modules())


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _public(name: str) -> bool:
    return not name.startswith("_") or name in ("__init__", "__call__")


def _class_members(node: ast.ClassDef) -> dict:
    """name -> parameter names (methods, properties) or None (fields and
    class attributes)."""
    members = {}
    for n in node.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(n.name):
            members[n.name] = _params(n)
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            if _public(n.target.id):
                members[n.target.id] = None
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and _public(t.id):
                    members[t.id] = None
    return members


def surface(path: str) -> dict:
    """name -> ("def", params) | ("class", members) | ("name", None) for the
    module's public top level (re-exports of an ``__init__.py`` as names)."""
    tree = ast.parse(open(path).read(), filename=path)
    out = {}
    init = os.path.basename(path) == "__init__.py"
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            out[node.name] = ("def", _params(node))
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out[node.name] = ("class", _class_members(node))
        elif init and isinstance(node, ast.ImportFrom):
            for alias in node.names:
                name = alias.asname or alias.name
                if not name.startswith("_"):
                    out.setdefault(name, ("name", None))
    return out


def gaps(module: str) -> list:
    """What the JAX module has and the port's does not, as
    "path: name", "path: name(param)", "path: Class.member" or
    "path: Class.method(param)"."""
    jax_surface = surface(os.path.join(JAX_PKG, module))
    port_path = os.path.join(PORT_PKG, module)
    if not os.path.exists(port_path):
        return [f"{module}: the module"]
    port_surface = surface(port_path)
    missing = []
    for name, (kind, info) in jax_surface.items():
        if name not in port_surface or port_surface[name][0] != kind:
            missing.append(f"{module}: {name}")
        elif kind == "def":
            missing += [f"{module}: {name}({p})" for p in info if p not in port_surface[name][1]]
        elif kind == "class":
            port_members = port_surface[name][1]
            for member, params in info.items():
                if member not in port_members:
                    missing.append(f"{module}: {name}.{member}")
                elif params is not None:
                    have = port_members[member] or []
                    missing += [f"{module}: {name}.{member}({p})" for p in params if p not in have]
    return missing


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_module_has_the_jax_surface(module):
    if module in REPLACED_MODULES:
        for path in REPLACED_MODULES[module]:
            assert os.path.exists(os.path.join(PORT_PKG, path)), (module, path)
        return
    unexplained = [g for g in gaps(module) if g not in ALLOWED]
    assert not unexplained, unexplained


def test_allowlist_has_no_stale_entry():
    found = {g for module in JAX_MODULES if module not in REPLACED_MODULES for g in gaps(module)}
    stale = sorted(set(ALLOWED) - found)
    assert not stale, stale


def test_allowlist_spares_the_profile_mode():
    for entry in ALLOWED:
        words = entry.replace("(", " ").replace(")", " ").replace(".", " ").split()
        assert not set(words) & set(REQUIRED), entry
    pipeline = surface(os.path.join(PORT_PKG, "pipelines/diarization.py"))
    assert "profile" in pipeline["SpeakerDiarizationPipeline"][1]["__init__"]
    assert {"embedding", "total"} <= set(pipeline["StageTimings"][1])
