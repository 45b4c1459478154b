"""Real-checkpoint ingestion: the published artifact formats, loaded directly.

The reference obtains its weights from three artifact families:

  - pyannote's Lightning checkpoint (``pytorch_model.bin`` /
    ``*.ckpt``) — what ``Model.from_pretrained("pyannote/segmentation@2022.07")``
    loads (reference segment/export2.py:16-53). A torch-zip archive whose
    pickled payload is ``{"state_dict": {...}, "hyper_parameters": ..., ...}``.
  - speechbrain's save directory — what
    ``EncoderClassifier.from_hparams("speechbrain/spkrec-ecapa-voxceleb")``
    materializes (reference embeddings/export3.py:560-627):
    ``<savedir>/embedding_model.ckpt``, a torch-zip archive of the raw
    ECAPA state dict.
  - the reference's own exported ONNX blobs ``segment2.onnx`` / ``emd4.onnx``
    (stripped from the mirror, but the format is fixed by
    segment/export2.py:40-52 and embeddings/export3.py:151-190).

This module reads all three **without torch.load or onnx**: a pure-Python
torch-zip unpickler (tensor storages -> numpy) and a minimal protobuf walker
for ONNX ModelProto. ``load_params_auto`` dispatches on the artifact so
``cli.py --checkpoint`` accepts any of them unmodified. Every loader returns
a params tree of numpy arrays in the JAX package's layout
(models/convert.py), equal array for array to what that package's
models/ingest.py gives.

Why not ``torch.load``: Lightning checkpoints carry arbitrary pickled
``hyper_parameters`` objects that ``torch.load(weights_only=True)``
refuses, and ``weights_only=False`` runs the pickle — the custom unpickler
stubs everything that is not a tensor, keeping loading safe AND complete.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import zipfile
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from .ecapa import EcapaConfig
from .pyannet import PyanNetConfig

# ---------------------------------------------------------------------------
# torch-zip checkpoint reader (pure Python)
# ---------------------------------------------------------------------------

# torch typed-storage pickle names -> numpy dtype readers
_STORAGE_DTYPES = {
    "FloatStorage": np.dtype("<f4"),
    "DoubleStorage": np.dtype("<f8"),
    "HalfStorage": np.dtype("<f2"),
    "LongStorage": np.dtype("<i8"),
    "IntStorage": np.dtype("<i4"),
    "ShortStorage": np.dtype("<i2"),
    "CharStorage": np.dtype("<i1"),
    "ByteStorage": np.dtype("<u1"),
    "BoolStorage": np.dtype("?"),
    "BFloat16Storage": np.dtype("<u2"),  # upcast to f32 below
    "ComplexFloatStorage": np.dtype("<c8"),
    "ComplexDoubleStorage": np.dtype("<c16"),
}


class _StorageType:
    """Sentinel carrying the element dtype of a torch typed storage."""

    def __init__(self, name: str):
        self.name = name
        self.dtype = _STORAGE_DTYPES.get(name)
        self.is_bf16 = name == "BFloat16Storage"


class _StubMeta(type):
    """Unknown globals may be used as classes (NEWOBJ/NEWOBJ_EX need a real
    type) or plain attributes; a metaclass keeps both paths inert."""

    def __getattr__(cls, name):
        return _Stub

    def __setstate__(cls, state):
        pass


class _Stub(metaclass=_StubMeta):
    """Swallows any non-tensor object in the pickle stream (Lightning
    hyper_parameters, loss specs, omegaconf nodes, ...). Every protocol the
    unpickler may drive is a no-op returning another stub."""

    def __init__(self, *a, **k):
        pass

    def __call__(self, *a, **k):
        return _Stub()

    def __setstate__(self, state):
        pass

    def __setitem__(self, k, v):
        pass

    def append(self, *a):
        pass

    def extend(self, *a):
        pass

    def update(self, *a, **k):
        pass


def _rebuild_tensor_v2(storage, storage_offset, size, stride, *unused):
    arr, is_bf16 = storage
    itemsize = arr.dtype.itemsize
    out = np.lib.stride_tricks.as_strided(
        arr[storage_offset:],
        shape=tuple(size),
        strides=tuple(s * itemsize for s in stride),
    ).copy()
    if is_bf16:
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


def _rebuild_parameter(data, *unused):
    return data


# The ONLY builtins a checkpoint pickle may resolve — the data-container set
# torch's own ``weights_only`` unpickler allows. Everything else (eval, exec,
# getattr, __import__, ...) becomes an inert _Stub: a crafted checkpoint must
# not reach code execution through REDUCE (these artifacts are third-party
# downloads; see module docstring).
_SAFE_BUILTINS = {
    "set",
    "frozenset",
    "complex",
    "bytearray",
    "slice",
    "list",
    "tuple",
    "dict",
    "str",
    "bytes",
    "int",
    "float",
    "bool",
}


class _TorchUnpickler(pickle.Unpickler):
    """Unpickles a torch-zip data.pkl: tensors become numpy arrays, every
    other custom global becomes a `_Stub`."""

    def __init__(self, file, read_storage):
        super().__init__(file)
        self._read_storage = read_storage

    def find_class(self, module, name):
        if module.startswith("torch") and name in _STORAGE_DTYPES:
            return _StorageType(name)
        if name == "_rebuild_tensor_v2":
            return _rebuild_tensor_v2
        if name in ("_rebuild_parameter", "_rebuild_parameter_with_state"):
            return _rebuild_parameter
        if (module, name) == ("collections", "OrderedDict"):
            return dict
        # "__builtin__" is the py2-compat module name protocol<=2 pickles
        # record (torch.save default); overriding find_class bypasses the
        # Unpickler's own fix_imports mapping
        if module in ("builtins", "__builtin__") and name in _SAFE_BUILTINS:
            return getattr(__import__("builtins"), name)
        if (module, name) == ("_codecs", "encode"):
            # bytearray's protocol-2 reduce goes through codecs.encode;
            # also on torch's weights_only allowlist
            import codecs

            return codecs.encode
        if (module, name) == ("torch", "Size"):
            return tuple
        return _Stub

    def persistent_load(self, pid):
        # ('storage', storage_type, key, location, numel)
        if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
            raise pickle.UnpicklingError(f"unexpected persistent id {pid!r}")
        _, storage_type, key, _location, _numel = pid
        if not isinstance(storage_type, _StorageType) or storage_type.dtype is None:
            raise pickle.UnpicklingError(
                f"unsupported torch storage type for key {key!r}"
            )
        raw = self._read_storage(str(key))
        return (np.frombuffer(raw, dtype=storage_type.dtype), storage_type.is_bf16)


def read_torch_checkpoint(path: str) -> Any:
    """Read a torch-zip checkpoint (``torch.save`` archive) without torch.

    Returns the pickled payload with tensors as numpy arrays and any
    non-tensor custom object replaced by an inert stub. Works on pyannote
    Lightning checkpoints and speechbrain module checkpoints alike.
    """
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        pkl_name = next((n for n in names if n.endswith("/data.pkl")), None)
        if pkl_name is None:
            pkl_name = next((n for n in names if n == "data.pkl"), None)
        if pkl_name is None:
            raise ValueError(
                f"{path}: not a torch-zip checkpoint (no data.pkl entry); "
                "legacy (non-zip) torch.save files are not supported"
            )
        root = pkl_name[: -len("data.pkl")]
        byteorder_name = f"{root}byteorder"
        if byteorder_name in names:
            order = zf.read(byteorder_name).decode().strip()
            if order != "little":
                raise ValueError(f"{path}: unsupported byte order {order!r}")

        cache: Dict[str, bytes] = {}

        def read_storage(key: str) -> bytes:
            if key not in cache:
                cache[key] = zf.read(f"{root}data/{key}")
            return cache[key]

        with zf.open(pkl_name) as f:
            data = f.read()
        return _TorchUnpickler(io.BytesIO(data), read_storage).load()


def _tensor_state_dict(obj: Any) -> Dict[str, np.ndarray]:
    """Extract the flat name->array mapping from a loaded checkpoint payload:
    unwraps Lightning's {'state_dict': ...}, drops stubs/non-tensors."""
    if isinstance(obj, Mapping) and isinstance(obj.get("state_dict"), Mapping):
        obj = obj["state_dict"]
    if not isinstance(obj, Mapping):
        raise ValueError("checkpoint payload is not a state dict")
    sd = {k: v for k, v in obj.items() if isinstance(v, np.ndarray)}
    if not sd:
        raise ValueError("checkpoint contains no tensors")
    return sd


def _strip_common_prefix(sd: Dict[str, np.ndarray], prefixes=("model.", "module.")):
    for prefix in prefixes:
        if all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return sd


# ---------------------------------------------------------------------------
# artifact-level loaders
# ---------------------------------------------------------------------------


def load_pyannote_checkpoint(
    path: str, cfg: PyanNetConfig = PyanNetConfig()
) -> Dict:
    """pyannote Lightning checkpoint (pytorch_model.bin / *.ckpt) ->
    segmentation pytree. Reference: segment/export2.py:16-22
    (``Model.from_pretrained`` = Lightning ``load_from_checkpoint``)."""
    from .convert import pyannet_from_pyannote

    sd = _strip_common_prefix(_tensor_state_dict(read_torch_checkpoint(path)))
    return pyannet_from_pyannote(sd, cfg)


def load_speechbrain_checkpoint(
    path: str, cfg: EcapaConfig = EcapaConfig()
) -> Dict:
    """speechbrain savedir (or its embedding_model.ckpt directly) -> ECAPA
    pytree. Reference: embeddings/export3.py:560-565
    (``EncoderClassifier.from_hparams(..., savedir="pretrained")`` keeps the
    embedding model at ``pretrained/embedding_model.ckpt``)."""
    from .convert import ecapa_from_speechbrain

    if os.path.isdir(path):
        candidate = os.path.join(path, "embedding_model.ckpt")
        if not os.path.exists(candidate):
            raise FileNotFoundError(f"{path}: no embedding_model.ckpt in savedir")
        path = candidate
    sd = _strip_common_prefix(
        _tensor_state_dict(read_torch_checkpoint(path)),
        prefixes=("model.", "module.", "embedding_model."),
    )
    return ecapa_from_speechbrain(sd, cfg)


def _classify_state_dict(sd: Mapping[str, np.ndarray]) -> Optional[str]:
    keys = list(sd)
    if any(k.startswith("sincnet.") or k.startswith("lstm.weight_ih_l0") for k in keys):
        return "segmentation"
    if any(k.startswith("blocks.0.conv") or k.startswith("embedding_model.blocks.") for k in keys):
        return "embedding"
    return None


# ---------------------------------------------------------------------------
# minimal ONNX (protobuf) reader
# ---------------------------------------------------------------------------

# TensorProto.DataType -> numpy dtype
_ONNX_DTYPES = {
    1: np.dtype("<f4"),  # FLOAT
    2: np.dtype("<u1"),  # UINT8
    3: np.dtype("<i1"),  # INT8
    5: np.dtype("<i2"),  # INT16
    6: np.dtype("<i4"),  # INT32
    7: np.dtype("<i8"),  # INT64
    9: np.dtype("?"),  # BOOL
    10: np.dtype("<f2"),  # FLOAT16
    11: np.dtype("<f8"),  # DOUBLE
    16: np.dtype("<u2"),  # BFLOAT16 (upcast below)
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.
    value: int for varint(0)/fixed(1,5), bytes for length-delimited(2)."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _parse_tensor_proto(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    data_type = 0
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int_data: List[int] = []
    double_data: List[float] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # dims (repeated int64; possibly packed)
            if wire == 0:
                dims.append(val)
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    dims.append(v)
        elif field == 2:
            data_type = val
        elif field == 4:  # float_data
            if wire == 5:
                float_data.append(struct.unpack("<f", struct.pack("<I", val))[0])
            else:
                float_data.extend(struct.unpack(f"<{len(val)//4}f", val))
        elif field == 7:  # int64_data
            if wire == 0:
                int_data.append(val)
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int_data.append(v)
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
        elif field == 11:  # double_data
            if wire == 1:
                double_data.append(struct.unpack("<d", struct.pack("<Q", val))[0])
            else:
                double_data.extend(struct.unpack(f"<{len(val)//8}d", val))
    dtype = _ONNX_DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"initializer {name!r}: unsupported ONNX dtype {data_type}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np.float32)
    elif double_data:
        arr = np.asarray(double_data, dtype=np.float64)
    elif int_data:
        # negative int64s are varint-encoded as 64-bit two's complement;
        # mask and reinterpret so e.g. a Reshape shape of -1 survives
        arr = (
            np.asarray(
                [v & 0xFFFFFFFFFFFFFFFF for v in int_data], dtype=np.uint64
            )
            .astype(np.int64)
            .astype(dtype)
        )
    else:
        arr = np.zeros(0, dtype=dtype)
    if data_type == 16:  # bfloat16 -> f32
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _parse_attribute_proto(buf: bytes) -> Tuple[str, Any]:
    """AttributeProto -> (name, value) for the scalar kinds the ingest
    paths inspect (int ``i``=3, float ``f``=2); other kinds yield None."""
    name, value = "", None
    for field, _wire, val in _iter_fields(buf):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 2:  # float f (fixed32)
            value = struct.unpack("<f", struct.pack("<I", val))[0]
        elif field == 3:  # int i (varint, zigzag NOT used by onnx here)
            value = int(val)
    return name, value


def _parse_node_proto(buf: bytes) -> Dict[str, Any]:
    node = {"inputs": [], "outputs": [], "name": "", "op_type": "", "attrs": {}}
    for field, _wire, val in _iter_fields(buf):
        if field == 1:
            node["inputs"].append(val.decode("utf-8"))
        elif field == 2:
            node["outputs"].append(val.decode("utf-8"))
        elif field == 3:
            node["name"] = val.decode("utf-8")
        elif field == 4:
            node["op_type"] = val.decode("utf-8")
        elif field == 5:
            aname, aval = _parse_attribute_proto(val)
            if aname:
                node["attrs"][aname] = aval
    return node


def read_onnx_model(path: str) -> Tuple[Dict[str, np.ndarray], List[Dict]]:
    """Parse an ONNX ModelProto file -> (initializers, graph nodes).

    Hand-rolled protobuf walk (ModelProto.graph=7, GraphProto.node=1,
    GraphProto.initializer=5) so no onnx package is required.
    """
    with open(path, "rb") as f:
        buf = f.read()
    graph = None
    for field, _wire, val in _iter_fields(buf):
        if field == 7:
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no graph in ONNX model")
    initializers: Dict[str, np.ndarray] = {}
    nodes: List[Dict] = []
    for field, _wire, val in _iter_fields(graph):
        if field == 5:
            name, arr = _parse_tensor_proto(val)
            initializers[name] = arr
        elif field == 1:
            nodes.append(_parse_node_proto(val))
    return initializers, nodes


# ONNX LSTM gate order is [i, o, f, c]; torch's is [i, f, c(g), o]
# (torch.onnx symbolic reorders when exporting nn.LSTM). Inverse permutation:
_ONNX2TORCH_GATES = (0, 2, 3, 1)


def _lstm_from_onnx(W: np.ndarray, R: np.ndarray, B: np.ndarray) -> List[Dict]:
    """One bidirectional ONNX LSTM node -> [fwd, bwd] torch-layout halves.

    ONNX shapes: W (num_dirs, 4H, input), R (num_dirs, 4H, H),
    B (num_dirs, 8H) = [Wb | Rb]."""
    num_dirs, four_h, _ = W.shape
    hidden = four_h // 4
    halves = []
    for d in range(num_dirs):
        w = W[d].reshape(4, hidden, -1)[list(_ONNX2TORCH_GATES)].reshape(4 * hidden, -1)
        r = R[d].reshape(4, hidden, -1)[list(_ONNX2TORCH_GATES)].reshape(4 * hidden, -1)
        b_ih = B[d, :four_h].reshape(4, hidden)[list(_ONNX2TORCH_GATES)].reshape(-1)
        b_hh = B[d, four_h:].reshape(4, hidden)[list(_ONNX2TORCH_GATES)].reshape(-1)
        halves.append(
            {"weight_ih": w, "weight_hh": r, "bias_ih": b_ih, "bias_hh": b_hh}
        )
    return halves


def pyannet_from_onnx(path: str, cfg: PyanNetConfig = PyanNetConfig()) -> Dict:
    """The reference's segment2.onnx (whole PyanNet, exported by
    segment/export2.py:40-52 with do_constant_folding=True) -> our pytree.

    Two formats are handled for the sinc filterbank: parameter initializers
    kept by name (low_hz_/band_hz_), or — the constant-folded case — a baked
    (num_filters, 1, kernel_size) conv weight, ingested as precomputed
    filters (models/convert.py build_pyannet then builds a PyanNet whose
    SincFilters holds them as a fixed buffer).
    LSTM weights come back from ONNX LSTM nodes with the [i,o,f,c] ->
    [i,f,g,o] gate reorder undone.

    nn.Linear layers export as MatMul+Add with the WEIGHT initializer
    renamed (``onnx::MatMul_N``) and transposed, while the BIAS keeps its
    state-dict name — verified against real ``torch.onnx.export`` output
    (the JAX package's tests/test_ingest_authentic.py); the linear stack and classifier are
    recovered by anchoring each surviving ``*.bias`` to the MatMul feeding
    its Add node.
    """
    from .convert import pyannet_from_pyannote

    inits, nodes = read_onnx_model(path)
    sd: Dict[str, np.ndarray] = dict(inits)

    have_sinc_params = any(k.endswith("low_hz_") for k in sd)
    have_lstm_params = "lstm.weight_ih_l0" in sd

    # recover MatMul-folded linear weights via their preserved bias names
    linear_bias_names = [k for k in sd if k.endswith(".bias") and (
        k.startswith("linear.") or k == "classifier.bias"
    )]
    producer = {out: n for n in nodes for out in n["outputs"]}
    for bias_name in linear_bias_names:
        weight_name = bias_name[: -len(".bias")] + ".weight"
        if weight_name in sd:
            continue
        recovered = False
        for add in (
            n for n in nodes
            if n["op_type"] == "Add" and bias_name in n["inputs"]
        ):
            for inp in add["inputs"]:
                src = producer.get(inp)
                if (
                    src is not None
                    and src["op_type"] == "MatMul"
                    and len(src["inputs"]) > 1
                    and src["inputs"][1] in inits
                ):
                    # ONNX MatMul weight is (in, out); torch layout is (out, in)
                    sd[weight_name] = np.ascontiguousarray(
                        inits[src["inputs"][1]].T
                    )
                    recovered = True
        if not recovered:
            # Gemm keeps weight+bias in ONE node (2-D inputs) — there is no
            # separate Add to anchor on, so this must be searched whether or
            # not any Add nodes exist
            for n in nodes:
                if (
                    n["op_type"] == "Gemm"
                    and bias_name in n["inputs"]
                    and n["inputs"][1] in inits
                ):
                    attrs = n.get("attrs", {})
                    alpha = attrs.get("alpha", 1.0)
                    beta = attrs.get("beta", 1.0)
                    if not (
                        abs(alpha - 1.0) < 1e-6 and abs(beta - 1.0) < 1e-6
                    ):
                        raise ValueError(
                            f"{path}: Gemm for {weight_name} has "
                            f"alpha={alpha}/beta={beta}; only 1.0 is "
                            "supported"
                        )
                    w = np.asarray(inits[n["inputs"][1]])
                    # torch exports transB=1 (weight already (out, in));
                    # other exporters may emit transB=0 with (in, out)
                    if not attrs.get("transB", 0):
                        w = np.ascontiguousarray(w.T)
                    sd[weight_name] = w
                    recovered = True
        if not recovered:
            raise ValueError(
                f"{path}: could not recover {weight_name} from the graph "
                "(no MatMul/Gemm anchored to its bias)"
            )

    if not have_lstm_params:
        # recover from ONNX LSTM nodes, in graph (= layer) order
        lstm_nodes = [n for n in nodes if n["op_type"] == "LSTM"]
        if len(lstm_nodes) != cfg.lstm_layers:
            raise ValueError(
                f"{path}: expected {cfg.lstm_layers} LSTM nodes, found {len(lstm_nodes)}"
            )
        for i, node in enumerate(lstm_nodes):
            # LSTM inputs: X, W, R, B, ...
            W, R, B = (inits[node["inputs"][j]] for j in (1, 2, 3))
            fwd, bwd = _lstm_from_onnx(W, R, B)
            for tag, half in (("", fwd), ("_reverse", bwd)):
                sd[f"lstm.weight_ih_l{i}{tag}"] = half["weight_ih"]
                sd[f"lstm.weight_hh_l{i}{tag}"] = half["weight_hh"]
                sd[f"lstm.bias_ih_l{i}{tag}"] = half["bias_ih"]
                sd[f"lstm.bias_hh_l{i}{tag}"] = half["bias_hh"]

    baked_filters = None
    if not have_sinc_params:
        # constant-folded filterbank: the first Conv's weight with the sinc
        # shape (num_filters, 1, kernel_size)
        want = (cfg.num_filters, 1, cfg.kernel_size)
        conv_weights = [
            inits[n["inputs"][1]]
            for n in nodes
            if n["op_type"] == "Conv"
            and len(n["inputs"]) > 1
            and n["inputs"][1] in inits
            and inits[n["inputs"][1]].shape == want
        ]
        if not conv_weights:
            conv_weights = [a for a in inits.values() if a.shape == want]
        if not conv_weights:
            raise ValueError(
                f"{path}: no sinc parameters and no folded filter of shape {want}"
            )
        baked_filters = conv_weights[0]
        # placeholder params so the name-based converter proceeds
        sd["sincnet.conv1d.0.low_hz_"] = np.zeros((cfg.num_filters, 1), np.float32)
        sd["sincnet.conv1d.0.band_hz_"] = np.zeros((cfg.num_filters, 1), np.float32)

    params = pyannet_from_pyannote(sd, cfg)
    if baked_filters is not None:
        params["sincnet"]["sinc"] = {"filters": np.asarray(baked_filters)}
    return params


def ecapa_from_onnx(path: str, cfg: EcapaConfig = EcapaConfig()) -> Dict:
    """The reference's emd4.onnx (MyEmbedding0: fbank+norm+ECAPA, exported by
    embeddings/export3.py:151-190) -> our ECAPA pytree. The fbank matmul and
    the paramless normalization leave no initializers; every ECAPA parameter
    keeps its ``embedding_model.``-prefixed state-dict name."""
    from .convert import ecapa_from_speechbrain

    inits, _nodes = read_onnx_model(path)
    sd = {}
    for k, v in inits.items():
        if k.startswith("embedding_model."):
            sd[k[len("embedding_model."):]] = v
        else:
            sd.setdefault(k, v)
    return ecapa_from_speechbrain(sd, cfg)


# ---------------------------------------------------------------------------
# auto-dispatch (cli.py --checkpoint)
# ---------------------------------------------------------------------------


def load_params_auto(path: str) -> Dict:
    """Load whatever weights artifact ``path`` is, returning a (possibly
    partial) ``{"segmentation": ..., "embedding": ...}`` params dict.

    Accepts: a converted .npz checkpoint directory; a pyannote Lightning
    checkpoint (.ckpt/.bin); a speechbrain savedir or embedding_model.ckpt;
    an ONNX blob (segment2.onnx / emd4.onnx layouts); or a directory holding
    any mix of these (each classified by its tensor names).
    """
    params: Dict = {}
    if os.path.isdir(path):
        entries = sorted(os.listdir(path))
        if any(e.endswith(".npz") for e in entries):
            from .convert import load_checkpoint

            return load_checkpoint(path)
        for entry in entries:
            full = os.path.join(path, entry)
            if not os.path.isfile(full):
                continue
            if entry.endswith((".ckpt", ".bin", ".pt", ".onnx")):
                try:
                    sub = load_params_auto(full)
                except (ValueError, KeyError, zipfile.BadZipFile):
                    continue
                for k, v in sub.items():
                    params.setdefault(k, v)
        if not params:
            raise FileNotFoundError(f"{path}: no loadable weights artifacts")
        return params

    if path.endswith(".onnx"):
        inits, _ = read_onnx_model(path)
        if any(k.startswith("embedding_model.") for k in inits) or any(
            k.startswith("blocks.0.") for k in inits
        ):
            return {"embedding": ecapa_from_onnx(path)}
        return {"segmentation": pyannet_from_onnx(path)}

    sd = _strip_common_prefix(_tensor_state_dict(read_torch_checkpoint(path)))
    kind = _classify_state_dict(sd)
    if kind == "segmentation":
        from .convert import pyannet_from_pyannote

        return {"segmentation": pyannet_from_pyannote(sd)}
    if kind == "embedding":
        from .convert import ecapa_from_speechbrain

        sd = _strip_common_prefix(sd, prefixes=("embedding_model.",))
        return {"embedding": ecapa_from_speechbrain(sd)}
    raise ValueError(f"{path}: cannot classify checkpoint (keys: {list(sd)[:5]}...)")
