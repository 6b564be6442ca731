"""Recorded outputs of the JAX package for the port's costliest parity
tests (``tests/golden/torch/``).

The JAX package is the frozen reference the port is held to; its
outputs on a test's inputs are the same on every run, so the tests that
would spend most of their time recomputing them read them back instead.
``scripts/gen_torch_references.py`` writes each recording from the live
package on exactly the test's inputs; ``python -m pytest -m slow
tests/test_torch_references.py`` rebuilds them all and compares them
with these files byte for byte.

A recording is ``<name>.npz`` (its arrays) and ``<name>.json``: the JAX
version that made it, the digest of the inputs it was made from, and
the recorded tree with each array leaf a ``{"npz": key}`` reference.
``load`` refuses a recording whose inputs' digest differs from the one
the test has built, so a test whose inputs drift fails instead of
comparing against another input's outputs.
"""
import dataclasses
import hashlib
import io
import json
import os
import zipfile

import numpy as np

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                   "torch")


def _feed(h, x):
    if hasattr(x, "_asdict"):  # a NamedTuple
        x = x._asdict()
    elif dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        h.update(b"{")
        for k in sorted(x):
            _feed(h, str(k))
            _feed(h, x[k])
        h.update(b"}")
    elif isinstance(x, (list, tuple)):
        h.update(b"[")
        for v in x:
            _feed(h, v)
        h.update(b"]")
    elif isinstance(x, bytes):
        h.update(b"b%d:" % len(x) + x)
    elif isinstance(x, str):
        _feed(h, x.encode())
    elif x is None or isinstance(x, (bool, int, float)):
        h.update(repr(x).encode())
    else:  # an array, of numpy or of either package
        a = np.ascontiguousarray(np.asarray(x))
        h.update(f"a{a.dtype.str}{a.shape}".encode() + a.tobytes())


def digest(inputs) -> str:
    """sha256 of a tree of dicts, lists, NamedTuples, dataclasses,
    arrays, strings, bytes and numbers (an array by its dtype, shape and
    bytes)."""
    h = hashlib.sha256()
    _feed(h, inputs)
    return h.hexdigest()


def file_digests(root: str, names) -> dict:
    """The sha256 of each file ``root/<name>``: inputs written to disk."""
    out = {}
    for name in names:
        with open(os.path.join(root, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def _split(x, arrays: dict, key: str):
    if isinstance(x, dict):
        return {str(k): _split(v, arrays, f"{key}/{k}") for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_split(v, arrays, f"{key}/{i}") for i, v in enumerate(x)]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    a = np.asarray(x)
    if a.ndim == 0 and a.dtype.kind in "biuf":
        return a.item()
    arrays[key] = a
    return {"npz": key}


def _join(x, arrays):
    if isinstance(x, dict):
        if set(x) == {"npz"}:
            return arrays[x["npz"]]
        return {k: _join(v, arrays) for k, v in x.items()}
    if isinstance(x, list):
        return [_join(v, arrays) for v in x]
    return x


def save(out_dir: str, name: str, inputs_digest: str, tree: dict,
         jax_version: str) -> None:
    """Write ``tree`` as ``<name>.npz`` (LZMA, which packs float fields
    far tighter than deflate) and ``<name>.json``, byte for byte the same
    on every run from the same values (fixed zip times)."""
    os.makedirs(out_dir, exist_ok=True)
    arrays = {}
    body = _split(tree, arrays, name)
    with zipfile.ZipFile(os.path.join(out_dir, name + ".npz"), "w",
                         zipfile.ZIP_LZMA) as z:
        for key in sorted(arrays):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.ascontiguousarray(arrays[key]),
                                      allow_pickle=False)
            info = zipfile.ZipInfo(key + ".npy", date_time=(1980, 1, 1, 0, 0,
                                                           0))
            info.compress_type = zipfile.ZIP_LZMA
            z.writestr(info, buf.getvalue())
    meta = {"jax_version": jax_version, "inputs_digest": inputs_digest,
            "tree": body}
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")


def meta(name: str, root: str = DIR) -> dict:
    with open(os.path.join(root, name + ".json")) as f:
        return json.load(f)


def load(name: str, inputs_digest: str, root: str = DIR) -> dict:
    """The recorded tree of ``name``, after checking that it was made
    from inputs with this digest."""
    m = meta(name, root)
    assert m["inputs_digest"] == inputs_digest, (
        f"{name}: the test's inputs differ from those of its recording; "
        "rebuild it with scripts/gen_torch_references.py")
    with np.load(os.path.join(root, name + ".npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return _join(m["tree"], arrays)
