"""Checkpointing: atomic, async, retention — the JAX package's
``CheckpointManager`` on torch tensors, with its on-disk format leaf for
leaf, so a checkpoint written by either package restores in the other.

* leaves are flattened in the reference's pytree order
  (:mod:`repro_torch.tree`: dict keys sorted, lists in order) and named as
  ``jax.tree_util.keystr`` names them (``"['m']['embed']"``,
  ``"['scan'][0]"``; ``/`` becomes ``_``); files are ``leaf_%05d.npy`` and
  ``manifest.json`` holds each leaf's name, file, shape and dtype;
* a bfloat16 leaf is written as the reference writes one (numpy has no
  bfloat16: an ``'<V2'`` array of the raw bits, manifest dtype
  ``"bfloat16"``) and read back bit for bit;
* a checkpoint is staged under ``<step>.tmp`` and renamed to ``<step>``
  once its manifest is fsync'd, so a crashed save is never mistaken for a
  complete one; re-saving a committed step changes nothing;
* ``save`` copies every leaf to host memory before it returns (training
  updates parameters and optimizer state in place), and only the file
  writing runs on a background thread; its error surfaces on the next
  ``wait()``;
* ``restore`` puts each leaf on the device of the matching leaf of
  ``like``, in its dtype (the stacked layout keeps every rank on one
  device, so placement is a device, not a sharding);
* retention keeps the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_paths, unflatten


def _leaf_name(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices,
    with ``/`` replaced by ``_`` (the reference's manifest names)."""
    return "".join(f"[{key!r}]" for key in path).replace("/", "_")


def _save_leaf(path: str, leaf: torch.Tensor) -> tuple[list, str]:
    """Write one host tensor as ``np.save`` writes the reference's leaf;
    returns its shape and manifest dtype."""
    if leaf.dtype == torch.bfloat16:
        bits = leaf.view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": "<V2", "fortran_order": False,
                "shape": tuple(bits.shape)})
            f.write(bits.tobytes())
        return list(bits.shape), "bfloat16"
    arr = leaf.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        #: the last save: bytes of its leaves, ms of its host copy and
        #: (once ``wait()`` returned) of the thread's write and commit
        self.stats: dict = {}

    # -- save -------------------------------------------------------------
    def save(self, step: int, state, *, blocking: bool = False) -> None:
        """Snapshot ``state`` (a tree of tensors) at ``step``.  The host
        copy is taken now (a blocking copy: the caller may update the
        tensors in place once this returns); the files are written on a
        thread unless ``blocking``."""
        self.wait()
        t0 = time.perf_counter()
        named = [(_leaf_name(path), x.detach().to("cpu", copy=True))
                 for path, x in leaves_with_paths(state)]
        self.stats = {"bytes": sum(x.numel() * x.element_size()
                                   for _, x in named),
                      "copy_ms": (time.perf_counter() - t0) * 1e3}

        def _write():
            try:
                t1 = time.perf_counter()
                tmp = os.path.join(self.dir, f"{step}.tmp")
                final = os.path.join(self.dir, str(step))
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                manifest = {"step": step, "leaves": []}
                for i, (name, leaf) in enumerate(named):
                    fn = f"leaf_{i:05d}.npy"
                    shape, dtype = _save_leaf(os.path.join(tmp, fn), leaf)
                    manifest["leaves"].append(
                        {"name": name, "file": fn, "shape": shape,
                         "dtype": dtype})
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):  # step already committed: idempotent
                    shutil.rmtree(tmp)
                else:
                    os.rename(tmp, final)  # atomic commit
                self._retain()
                self.stats["write_ms"] = (time.perf_counter() - t1) * 1e3
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ----------------------------------------------------------
    def _steps(self) -> list[int]:
        return sorted(
            int(d) for d in os.listdir(self.dir) if re.fullmatch(r"\d+", d)
            and os.path.exists(os.path.join(self.dir, d, "manifest.json")))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, *, device=None):
        """Load checkpoint ``step`` into the structure of ``like``: each
        leaf on ``device`` (default: the device of ``like``'s leaf) in the
        dtype of ``like``'s leaf."""
        d = os.path.join(self.dir, str(step))
        if not os.path.exists(os.path.join(d, "manifest.json")):
            steps = self._steps()
            raise FileNotFoundError(
                f"checkpoint step {step} not found in {self.dir} "
                f"(available steps: {steps if steps else 'none'})")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat_like = leaves(like)
        if len(manifest["leaves"]) != len(flat_like):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"model expects {len(flat_like)}")
        out = []
        for meta, ref in zip(manifest["leaves"], flat_like):
            t = _load_leaf(os.path.join(d, meta["file"]), meta["dtype"])
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(
                    f"{meta['name']}: shape {tuple(t.shape)} != expected "
                    f"{tuple(ref.shape)}")
            out.append(t.to(device=ref.device if device is None else device,
                            dtype=ref.dtype))
        return unflatten(like, out)

    # -- retention --------------------------------------------------------
    def _retain(self) -> None:
        steps = sorted(
            (int(d) for d in os.listdir(self.dir) if re.fullmatch(r"\d+", d)),
            reverse=True)
        for s in steps[self.keep:]:
            shutil.rmtree(os.path.join(self.dir, str(s)), ignore_errors=True)


__all__ = ["CheckpointManager"]
