"""Program and parameter serialization: the port's counterpart of
tpudl.export.export.

- ``export_stablehlo`` -> ``export_program``: ``torch.export.export`` of
  the function, serialized with ``torch.export.save`` (a ``.pt2``
  archive). A contract of tpudl_torch.models.generate (or any function
  with a ``functional`` form) is traced through
  ``torch.func.functional_call`` on its model, which may be built on
  ``meta``: the parameters are the artifact's first input and it holds
  no weights (a Llama-3-8B artifact is megabytes, not 16 GB). The
  trace's example inputs are dropped before saving for the same reason.
- Orbax checkpoints -> the safetensors format (``save_params`` /
  ``load_params``), written and read here with PyTorch alone: an 8-byte
  little-endian header length, a JSON header of dtype, shape and byte
  offsets per tensor, then the raw little-endian bytes.
- ``artifact_sizes``: byte sizes of files and directories.

The kernels in a program are ``tpudl::`` ops (tpudl_torch.ops.library),
so one artifact runs on the card and on the CPU; ``load_exported_obj``
moves a loaded program to a device (``move_to_device_pass``), which
rewrites the devices the trace baked into tensor constructors.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch
from torch import nn


class _Program(nn.Module):
    """The traced root: ``fn`` is held as a plain attribute, so whatever
    module it calls is not a submodule and lends the program no
    parameters."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def trace_program(fn: Callable, args: Sequence[Any]
                  ) -> "torch.export.ExportedProgram":
    """``torch.export.export`` of ``fn`` at ``args`` (static shapes: the
    serving contract); a contract is traced through its ``functional``
    form."""
    fn = getattr(fn, "functional", fn)
    # Traced without autograd (no parameter needs a gradient), so the
    # graph holds no grad-mode regions and the wrappers take their ops.
    with torch.no_grad():
        program = torch.export.export(_Program(fn), tuple(args))
    # The example inputs would be saved with the program (a model's
    # weights, for a contract).
    program._example_inputs = None
    return program


def forward_fn(model: nn.Module, **kwargs) -> Callable:
    """``model``'s forward as a function of its parameters, the form an
    artifact takes: ``fn(params, *args)`` runs ``model(*args, **kwargs)``
    with ``params`` (the model's state_dict: weights and buffers, e.g.
    BatchNorm statistics) bound in place of the module's own, and
    ``fn.functional`` is the same through ``torch.func.functional_call``,
    which ``export_program`` traces (``model`` may live on ``meta``)."""

    def functional(params, *args):
        return torch.func.functional_call(model, params, args, kwargs)

    def fn(params, *args):
        with torch.no_grad():
            return functional(params, *args)

    fn.functional = functional
    return fn


def _write(path: str, data: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def export_program(fn: Callable, args: Sequence[Any],
                   path: Optional[str] = None) -> bytes:
    """Trace ``fn`` at ``args`` and serialize the program (the ``.pt2``
    bytes); with ``path``, also write them there (a temporary file, then
    ``os.replace``)."""
    buf = io.BytesIO()
    torch.export.save(trace_program(fn, args), buf)
    blob = buf.getvalue()
    if path:
        _write(path, blob)
    return blob


def load_exported_obj(blob_or_path: Union[bytes, str],
                      device: Optional[Union[str, torch.device]] = None
                      ) -> "torch.export.ExportedProgram":
    """Deserialize an artifact into the ``ExportedProgram``: callable via
    ``.module()`` and introspectable through its input placeholders
    (``input_values``), which is how ``ServeSession.from_artifacts``
    recovers the serving shapes from the artifact alone. ``device``
    moves it there (``move_to_device_pass``)."""
    source = blob_or_path if isinstance(blob_or_path, str) else "<bytes>"
    try:
        if isinstance(blob_or_path, str):
            program = torch.export.load(blob_or_path)
        else:
            program = torch.export.load(io.BytesIO(blob_or_path))
    except Exception as e:
        raise ValueError(
            f"{source} is not a serialized torch.export program (expected "
            f"the output of export_program): {type(e).__name__}: {e}") from e
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    return program


def load_exported(blob_or_path: Union[bytes, str],
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Callable:
    """Deserialize an artifact into a callable (the InferenceSession
    analog): the program's module, which takes the traced arguments and
    writes a mutated input (a cache) back in place."""
    return load_exported_obj(blob_or_path, device).module()


def input_values(program) -> tuple:
    """The traced arguments of ``program`` as their fake values (shape,
    dtype, device), in the pytree of the call: ``(args, kwargs)``."""
    from torch.utils import _pytree

    names = set(program.graph_signature.user_inputs)
    values = [node.meta["val"] for node in program.graph.nodes
              if node.op == "placeholder" and node.name in names]
    return _pytree.tree_unflatten(values, program.call_spec.in_spec)


# ---------------------------------------------------------------------------
# parameters: the safetensors format
# ---------------------------------------------------------------------------

_DTYPES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
    torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
    torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
    torch.bool: "BOOL",
}
_BY_NAME = {v: k for k, v in _DTYPES.items()}


def _flat(params: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict of tensors as ``{"a.b.c": tensor}``."""
    out = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, f"{name}."))
        else:
            out[name] = v
    return out


def save_params(path: str, params: Dict[str, Any],
                overwrite: bool = True) -> None:
    """Write a (possibly nested) dict of tensors to ``path`` in the
    safetensors format (nested keys joined with "."): the torch.save
    analog of the reference, tpudl's Orbax checkpoint. Written to a
    temporary file, then ``os.replace``d."""
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    tensors = _flat(params)
    header, chunks, offset = {}, [], 0
    for name, t in tensors.items():
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name")
        data = t.detach().contiguous().cpu().reshape(-1).view(
            torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    _write(path, struct.pack("<Q", len(text)) + text + b"".join(chunks))


def load_params(path: str, like: Optional[Dict[str, Any]] = None,
                device: Optional[Union[str, torch.device]] = None
                ) -> Dict[str, torch.Tensor]:
    """Read a safetensors file into ``{name: tensor}`` (on ``device``,
    default the CPU), in the file's order. With ``like`` (a flat or
    nested dict of tensors), the keys, shapes and dtypes must match it,
    and the result follows its key order and its tensors' devices."""
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    header.pop("__metadata__", None)
    body = memoryview(raw)[8 + n:]
    out = {}
    for name, spec in header.items():
        begin, end = spec["data_offsets"]
        flat = torch.frombuffer(bytearray(body[begin:end]), dtype=torch.uint8)
        t = flat.view(_BY_NAME[spec["dtype"]]).reshape(spec["shape"])
        out[name] = t if device is None else t.to(device)
    if like is None:
        return out
    want = _flat(like)
    if set(want) != set(out):
        first = next((k for k in want if k not in out), None)
        if first is None:
            first = next(k for k in out if k not in want)
        raise ValueError(f"{path} holds other keys than expected (first "
                         f"difference: {first!r}; {len(out)} keys against "
                         f"{len(want)})")
    result = {}
    for name, ref in want.items():
        t = out[name]
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} in {path}, "
                             f"expected {tuple(ref.shape)} {ref.dtype}")
        result[name] = t.to(ref.device)
    return result


def artifact_sizes(*paths: str) -> dict:
    """Byte sizes of export artifacts (files or directories; None for a
    path that does not exist)."""
    out = {}
    for p in paths:
        if os.path.isdir(p):
            total = 0
            for root, _, files in os.walk(p):
                total += sum(os.path.getsize(os.path.join(root, f))
                             for f in files)
            out[p] = total
        elif os.path.exists(p):
            out[p] = os.path.getsize(p)
        else:
            out[p] = None
    return out
