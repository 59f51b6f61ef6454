"""Restricted loading of PyTorch checkpoint files: no code from the file runs.

Counterpart of ``diff_sampler_tpu/models/torch_import.py``'s loader (the
port's modules carry the reference's state_dict names, so its
``state_dict_to_params`` has no counterpart here).  The reference's EDM
``.pkl`` snapshots embed their class source through
``torch_utils/persistence.py`` and run it on unpickle; this loader rebuilds
only tensors and plain containers, and every other class becomes an inert
stub whose ``_parameters`` / ``_buffers`` / ``_modules`` are walked.

Two file formats load:
  * a torch zip archive (``torch.save``; ``.pt`` / ``.pth`` / ``.ckpt``,
    and ``.pkl`` written by ``torch.save``), each storage a zip member;
  * a plain pickle (``pickle.dump`` of modules or tensors; EDM's ``.pkl``,
    the NVIDIA metric pickles), each storage a legacy ``torch.save`` stream
    inside ``torch.storage._load_from_bytes``.

Each storage is read once and copied once into a writable buffer that the
tensors view; bf16 storages widen to f32, as in the JAX package.
"""

from __future__ import annotations

import io
import pickle
import zipfile
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["load_torch_file", "torch_state_dict"]


class _TensorStub:
    """A tensor as the pickle describes it: (storage, offset, size, stride)."""

    def __init__(self, storage: torch.Tensor, storage_offset, size, stride):
        self.storage = storage
        self.storage_offset = int(storage_offset)
        self.size = tuple(size)
        self.stride = tuple(stride)

    def to_tensor(self) -> torch.Tensor:
        """The tensor: a view of the whole storage where it covers it
        contiguously, else a contiguous copy of the strided window."""
        s = self.storage
        if not self.size:
            return s[self.storage_offset].clone()
        t = torch.as_strided(s, self.size, self.stride, self.storage_offset)
        if self.storage_offset == 0 and t.numel() == s.numel() and t.is_contiguous():
            return t
        return t.contiguous()


_DTYPES = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
}


def _bf16_to_f32(raw) -> np.ndarray:
    """bf16 bytes -> f32 (the bf16 bits in the high half of each word)."""
    u16 = np.frombuffer(raw, dtype=np.uint16)
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _storage(raw, type_name: str, count=None) -> torch.Tensor:
    """A 1-D tensor over a fresh, writable copy of the storage bytes ``raw``
    (bf16 widened to f32); ``count`` elements where given, else all."""
    if "BFloat16" in type_name:
        n = len(raw) // 2 if count is None else count
        arr = _bf16_to_f32(memoryview(raw)[:2 * n])
    else:
        dtype = next((v for k, v in _DTYPES.items() if k in type_name), None)
        if dtype is None:  # an untyped storage: bytes
            dtype = np.uint8
        n = len(raw) // np.dtype(dtype).itemsize if count is None else count
        # np.frombuffer views the read-only bytes: copy them once, writable
        arr = np.frombuffer(raw, dtype=dtype, count=n).copy()
    return torch.from_numpy(arr)


def _type_name(storage_type) -> str:
    return getattr(storage_type, "__name__", str(storage_type))


class _DictStub(dict):
    """OrderedDict stand-in that absorbs instance state set by BUILD (e.g.
    a state_dict's ``_metadata``)."""

    def __setstate__(self, state):
        pass


class _ObjStub:
    """Inert reconstruction target for any other pickled class.  Built via
    __init__ (REDUCE) or bare __new__ + BUILD (NEWOBJ), so the defaults
    live on the class."""

    _qualname = "?"
    args = ()
    kwargs: dict = {}
    state: dict = {}

    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs

    def __setstate__(self, state):
        self.state = state if isinstance(state, dict) else {"__state__": state}


_STUB_CACHE: Dict[str, type] = {}


def _make_stub(module: str, name: str) -> type:
    key = f"{module}.{name}"
    if key not in _STUB_CACHE:
        _STUB_CACHE[key] = type(name, (_ObjStub,), {"_qualname": key})
    return _STUB_CACHE[key]


def _rebuild_tensor(storage, offset, size, stride, *_a, **_k):
    return _TensorStub(storage, offset, size, stride)


def _rebuild_parameter(tensor, *_a, **_k):
    return tensor


def _find_common(module: str, name: str):
    """The classes and functions both unpicklers rebuild; None otherwise."""
    if module == "collections" and name == "OrderedDict":
        return _DictStub
    if (module, name) == ("torch._utils", "_rebuild_tensor_v2"):
        return _rebuild_tensor
    if (module, name) == ("torch._utils", "_rebuild_parameter"):
        return _rebuild_parameter
    if module.startswith("torch") and "Storage" in name:
        return type(name, (), {"__name__": name})
    return None


class _SafeUnpickler(pickle.Unpickler):
    """The ``data.pkl`` of a torch zip archive: storages are zip members,
    read when the pickle names them."""

    def __init__(self, f, zf: zipfile.ZipFile, archive_root: str):
        super().__init__(f)
        self._zf = zf
        self._root = archive_root
        self._storages: Dict[str, torch.Tensor] = {}

    def persistent_load(self, pid):
        typename, storage_type, key = pid[0], pid[1], pid[2]
        if typename != "storage":
            raise pickle.UnpicklingError(f"unexpected persistent id {pid!r}")
        if key not in self._storages:  # a storage shared by several tensors
            self._storages[key] = _storage(self._zf.read(f"{self._root}/data/{key}"),
                                           _type_name(storage_type))
        return self._storages[key]

    def find_class(self, module, name):
        found = _find_common(module, name)
        # anything else (persistence-wrapped modules, nn.Module subclasses,
        # EasyDict, ...) becomes an inert stub class: no embedded code runs
        return found if found is not None else _make_stub(module, name)


def _parse_legacy_storage_bytes(b) -> torch.Tensor:
    """The payload of ``torch.storage._load_from_bytes``: a legacy
    ``torch.save`` stream holding one storage (magic number, protocol and
    system-info pickles, a storage-ref pickle, the key list pickle, then an
    i64 count and the raw data)."""
    f = io.BytesIO(b)
    for _ in range(3):  # magic number, protocol version, sys info
        pickle.load(f)
    info: Dict[str, Any] = {}

    class _StorageRef(pickle.Unpickler):
        def persistent_load(self, pid):
            if pid[0] != "storage":
                raise pickle.UnpicklingError(f"unexpected persistent id {pid!r}")
            info["type"] = _type_name(pid[1])

        def find_class(self, module, name):
            return type(name, (), {"__name__": name})

    _StorageRef(f).load()
    keys = pickle.load(f)
    if len(keys) != 1:
        raise pickle.UnpicklingError(f"expected one storage, got {keys!r}")
    count = int.from_bytes(f.read(8), "little")
    raw = memoryview(b)[f.tell():]
    name = info.get("type", "")
    if not any(k in name for k in _DTYPES) and "BFloat16" not in name:
        count = min(count, len(raw))  # an untyped storage counts bytes
    return _storage(raw, name, count)


class _SafePlainUnpickler(pickle.Unpickler):
    """A plain pickle of torch objects: each storage inline through
    ``torch.storage._load_from_bytes``."""

    def find_class(self, module, name):
        if (module, name) == ("torch.storage", "_load_from_bytes"):
            return _parse_legacy_storage_bytes
        found = _find_common(module, name)
        if found is not None:
            return found
        if module == "builtins":
            return {"set": set, "frozenset": frozenset, "list": list, "dict": dict,
                    "tuple": tuple}.get(name, _make_stub(module, name))
        return _make_stub(module, name)


def _materialize(obj):
    """Tensor stubs -> tensors, through containers and stubs' args / state."""
    if isinstance(obj, _TensorStub):
        return obj.to_tensor()
    if isinstance(obj, dict):
        return {k: _materialize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_materialize(v) for v in obj)
    if isinstance(obj, _ObjStub):
        obj.args = _materialize(obj.args)
        obj.kwargs = _materialize(obj.kwargs)
        obj.state = _materialize(obj.state)
        return obj
    return obj


def _load_archive(zf: zipfile.ZipFile, where: str) -> Any:
    pkl_name = next((n for n in zf.namelist() if n.endswith("data.pkl")), None)
    if pkl_name is None:
        raise ValueError(f"{where} is a zip without a data.pkl member: not a torch archive")
    root = pkl_name[: -len("/data.pkl")]
    with zf.open(pkl_name) as f:
        return _SafeUnpickler(io.BytesIO(f.read()), zf, root).load()


def load_torch_file(path: str) -> Any:
    """A torch checkpoint, unpickled without running any code from it: a
    torch zip archive or a plain pickle.  Returns the object with CPU
    torch tensors (each storage's own dtype; bf16 as f32).

    A zip without ``data.pkl`` that holds exactly one ``*.ckpt`` member (the
    latent-diffusion distribution archives: ``model.ckpt`` and
    ``config.yaml``) loads that member, itself a torch zip; with none or
    several such members it raises and names the members."""
    if not zipfile.is_zipfile(path):
        with open(path, "rb") as f:
            obj = _SafePlainUnpickler(f).load()
        return _materialize(obj)
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if any(n.endswith("data.pkl") for n in names):
            return _materialize(_load_archive(zf, path))
        ckpts = [n for n in names if n.endswith(".ckpt")]
        if len(ckpts) != 1:
            raise ValueError(f"{path} is neither a torch archive (no data.pkl) nor an archive "
                             f"of one .ckpt; its members: {names}")
        inner = io.BytesIO(zf.read(ckpts[0]))
    where = f"{path}/{ckpts[0]}"
    if not zipfile.is_zipfile(inner):
        raise ValueError(f"{where} is not a torch zip archive")
    with zipfile.ZipFile(inner) as zf:
        return _materialize(_load_archive(zf, where))


def _walk_module_stub(stub, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """Collect ``_parameters`` / ``_buffers`` from a pickled nn.Module tree
    (a module pickles its __dict__: _parameters, _buffers, _modules); the
    top module and every child are read through ``_module_state``."""
    state = _module_state(stub)
    if not isinstance(state, dict):
        return
    for group in ("_parameters", "_buffers"):
        for name, val in (state.get(group) or {}).items():
            if isinstance(val, torch.Tensor):
                out[f"{prefix}.{name}" if prefix else str(name)] = val
    for name, sub in (state.get("_modules") or {}).items():
        _walk_module_stub(sub, f"{prefix}.{name}" if prefix else str(name), out)


def _module_state(obj):
    """The __dict__ of a pickled module: a stub's BUILD state (a plain
    module pickle), the ``state`` entry of it, or, for an object that
    ``torch_utils.persistence`` pickled (``_reconstruct_persistent_obj(meta)``
    with no BUILD; EDM wraps every layer class so, each child too), the
    ``state`` of its one argument ``meta``.  A dict is its own state; a
    stub whose state leads back to itself has none."""
    seen = set()
    while isinstance(obj, _ObjStub) and id(obj) not in seen:
        seen.add(id(obj))
        state = obj.state if isinstance(obj.state, dict) else {}
        if "_modules" in state or "_parameters" in state:
            return state
        if isinstance(state.get("state"), (dict, _ObjStub)):
            obj = state["state"]
        elif (not state and len(obj.args) == 1 and isinstance(obj.args[0], dict)
              and isinstance(obj.args[0].get("state"), (dict, _ObjStub))):
            obj = obj.args[0]["state"]
        else:
            return state
    return obj


def _as_f32(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Floating tensors in f32 (f16 / f64 storages convert one at a time);
    integer and bool buffers keep their dtype."""
    return {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}


def torch_state_dict(obj) -> Dict[str, torch.Tensor]:
    """A flat {name: tensor} of a loaded checkpoint object, floating tensors
    in f32: a raw state_dict, an {'ema' / 'state_dict' / 'model' / 'net':
    ...} container, or a pickled module object (EDM's persistence-wrapped
    snapshots) walked through its ``_parameters`` / ``_buffers``."""
    if isinstance(obj, dict) and obj and all(isinstance(v, torch.Tensor) for v in obj.values()):
        return _as_f32(obj)
    if isinstance(obj, _ObjStub):
        out: Dict[str, torch.Tensor] = {}
        _walk_module_stub(obj, "", out)
        if out:
            return _as_f32(out)
        raise ValueError(f"no tensors found in pickled object {obj._qualname}")
    if isinstance(obj, dict):
        for key in ("ema", "state_dict", "model", "net"):
            if key in obj:
                return torch_state_dict(obj[key])
    raise ValueError("could not locate a state_dict in checkpoint object")
