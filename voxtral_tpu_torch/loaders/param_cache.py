"""Save / load converted parameter trees (port of
``voxtral_tpu/loaders/param_cache.py``).

Repacking a GGUF or requantizing SafeTensors weights to w8 costs minutes
per load at production scale; a restart should not pay it twice.
:func:`save_params` writes a tree as a ``<path>.npd/`` directory of raw
``.npy`` leaves (files named by index) and a ``<path>.json`` skeleton
(the tree's structure, each leaf's key and dtype); :func:`load_params`
memory-maps the leaves back, so a warm restore reads each leaf once, on
its way to the device.

The on-disk format, the entry names and :data:`CACHE_FORMAT_VERSION`
are the JAX package's, so an entry written by either package is read by
the other: bf16 leaves are stored as their raw uint16 words with the
dtype "bfloat16" in the skeleton.  Leaves may be numpy arrays (the
builders' host trees) or tensors.
"""

from __future__ import annotations

import hashlib
import json
import logging
import shutil
import time
import warnings
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from voxtral_tpu_torch.device import DeviceLike, resolve_device

Params = dict[str, Any]

log = logging.getLogger("voxtral_tpu_torch")

_SEP = "."

# The JAX package's: bumped when the layout or a weight format's tree
# changes, so stale entries miss instead of mis-loading.
CACHE_FORMAT_VERSION = 2


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """(the array as stored, its dtype name): bf16 as uint16 words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, a.dtype.name
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def save_params(params: Params, path: str | Path) -> None:
    """Write the tree to ``<path>.npd/`` (raw .npy per leaf) and
    ``<path>.json`` (skeleton + key -> file index)."""
    path = Path(path)
    d = Path(str(path) + ".npd")
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    index: dict[str, int] = {}

    def walk(node, prefix: str):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{_SEP}{k}" if prefix else k)
                    for k, v in node.items()}
        stored, dtype = _host_array(node)
        index[prefix] = len(index)
        np.save(d / f"{index[prefix]}.npy", stored, allow_pickle=False)
        return {"__leaf__": prefix, "dtype": dtype}

    skeleton = walk(params, "")
    Path(str(path) + ".json").write_text(
        json.dumps({"skeleton": skeleton, "index": index}))


def load_params(path: str | Path, device: DeviceLike = None,
                to_device: bool = True) -> Params:
    """Memory-map a saved tree back: tensors on ``device`` (``None``: the
    card), each leaf read once from its mapping; or, with
    ``to_device=False``, the JAX package's numpy tree (bf16 as ml_dtypes'
    bfloat16)."""
    path = Path(path)
    meta = json.loads(Path(str(path) + ".json").read_text())
    skeleton, index = meta["skeleton"], meta["index"]
    d = Path(str(path) + ".npd")
    dev = resolve_device(device) if to_device else None

    def leaf(node):
        arr = np.load(d / f"{index[node['__leaf__']]}.npy", mmap_mode="r",
                      allow_pickle=False)
        bf16 = node["dtype"] == "bfloat16"
        if not to_device:
            if bf16:
                import ml_dtypes

                arr = arr.view(ml_dtypes.bfloat16)
            return arr
        with warnings.catch_warnings():  # a read-only mapping, read once
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(arr)
        if bf16:
            t = t.view(torch.bfloat16)
        # On the CPU the copy must not keep the read-only mapping.
        return t.clone() if dev.type == "cpu" else t.to(dev)

    def rebuild(node):
        if isinstance(node, dict) and "__leaf__" in node:
            return leaf(node)
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(skeleton)


def cache_entry(cache_dir: str | Path, source: str | Path, tag: str) -> Path:
    """Deterministic cache basename for a (weight source, format) pair:
    a hash of the resolved source path, its size and mtime_ns, ``tag``
    (the weight format, e.g. "w8" / "q4g") and
    :data:`CACHE_FORMAT_VERSION` (the JAX package's key, so the two
    packages find each other's entries)."""
    src = Path(source).resolve()
    st = src.stat()
    key = f"{src}:{st.st_size}:{st.st_mtime_ns}:{tag}"
    h = hashlib.sha1(
        f"{key}:v{CACHE_FORMAT_VERSION}".encode()).hexdigest()[:16]
    return Path(cache_dir) / f"{src.stem}-{tag}-{h}"


def load_or_build(cache_dir: str | Path, source: str | Path, tag: str,
                  builder: Callable[[], Params], device: DeviceLike = None,
                  to_device: bool = True) -> Params:
    """The converted tree of ``source`` from the cache, or ``builder()``'s
    (a host tree: numpy leaves in the converted format), saved for the
    next load.  A corrupt or partial entry counts as a miss."""
    base = cache_entry(cache_dir, source, tag)
    npd, js = Path(str(base) + ".npd"), Path(str(base) + ".json")
    if npd.is_dir() and js.exists():
        t0 = time.time()
        try:
            params = load_params(base, device, to_device)
            log.info("params-cache hit %s (%.1fs)", base.name,
                     time.time() - t0)
            return params
        except Exception as e:  # partial write / schema drift -> rebuild
            log.warning("params-cache entry %s unreadable (%s); rebuilding",
                        base.name, e)
    t0 = time.time()
    params = builder()
    build_s = time.time() - t0
    base.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    # Atomic publish: write under a temporary basename, rename the
    # directory, then the .json (readers key on the .json).
    tmp = Path(str(base) + ".tmp")
    save_params(params, tmp)
    if npd.exists():
        shutil.rmtree(npd)
    Path(str(tmp) + ".npd").rename(npd)
    Path(str(tmp) + ".json").rename(js)
    log.info("params-cache miss %s: built %.1fs, saved %.1fs",
             base.name, build_s, time.time() - t0)
    if not to_device:
        return params
    from voxtral_tpu_torch.convert import params_from_numpy

    return params_from_numpy(params, device)
