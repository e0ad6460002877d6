"""Checkpointing: atomic, versioned, async-capable, elastic on restore; the
counterpart of `repro.ckpt.checkpointer`, in the same on-disk layout, so
either package reads the other's checkpoints:

    <dir>/step_<N>/            N as %010d
        manifest.json          structure, shapes, dtypes, step, extras
        arr_<i>.npy            one file per leaf, the FULL logical array,
                               in `DPMRState` field order, or for a dict
                               tree (the dense trainer's state) in the
                               reference's order: keys sorted at every
                               level, so `opt`, `params`, `step`

Guarantees:
  - atomicity, twice over: leaves land in `step_<N>.tmp`, which is
    os.replace'd into place only when complete, and inside it the
    manifest is written to a temporary name, fsync'd and os.replace'd
    last, so a complete `manifest.json` defines a complete checkpoint.
    `all_steps` counts only step directories whose manifest parses: a
    crash mid-write makes that step invisible, and restore falls back to
    the previous good one.
  - keep-N retention.
  - elastic restore: leaves are full logical arrays, so a state saved at
    P ranks restores at any other P (`restore_host` hands back the raw
    arrays; `runtime/elastic.py` re-pads the DPMR table).
  - async: the port updates the state's tensors IN PLACE (no donation),
    so the snapshot must be taken before the next step writes them.
    `save` enqueues the device-to-host copies on the CURRENT stream into
    pinned host buffers that the checkpointer allocates once per leaf
    shape and keeps, and records an event after them; stream order then
    runs the next step's in-place updates after the copies, and `save`
    returns without waiting for the device. The writer (inline with
    `block=True`, on a thread with `block=False`) waits on the event, then
    serializes, fsyncs and renames. `wait()` joins it (and raises what it
    raised); every save joins the previous one first, so the buffers are
    free to reuse.

A dense train state (`{"params": model, "opt", "step"}`) is saved as
the reference's tree (`convert.train_state_tree`): each layer-stacked
leaf is copied a layer at a time into one (L, ...) host buffer, with no
stacked copy on the card, and `restore` copies the arrays back into the
live tensors of a state of the same structure. Either package restores
the other's dense checkpoint.

Multi-rank: every rank calls `save` with the mesh (the gather of the
sharded leaves, every rank's block in rank order, is a collective), and
only rank 0 touches the filesystem; the directory must be shared. A
blocking save ends with a barrier, so no rank returns before the step is
on disk. Restore reads the full arrays on every rank and cuts its blocks
(`convert.state_from_numpy`). A dense train state over a mesh (its
model carries a `core.fsdp.ParamLayout`) is saved as its whole leaves,
each gathered on every rank just before rank 0 copies it to the host, so
no rank holds more than one whole leaf at a time; the files are those of
a one-card state: they restore at any mesh, or at none, into each rank's
blocks (`runtime.elastic.reshard_tree`), and in either package.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import (
    SHARDED,
    params_tree,
    state_from_numpy,
    train_state_tree,
    tree_leaves,
)
from repro_torch.runtime import multiprocess


def _sharded(state) -> bool:
    """A dense train state laid out over a mesh (its model carries the
    layout)."""
    return isinstance(state, dict) and getattr(state.get("params"),
                                               "layout", None) is not None


class _Whole:
    """A leaf of a sharded state read as the whole leaf: gathered over the
    mesh (a collective) only when it is copied to the host, so a save
    holds one whole leaf at a time, never the whole state."""

    def __init__(self, layout, name: str, block: torch.Tensor):
        self.layout, self.name, self.block = layout, name, block.detach()
        self.shape = torch.Size(layout.defs[name].shape)
        self.dtype, self.is_cuda = block.dtype, block.is_cuda

    def detach(self):
        return self

    def gather(self) -> torch.Tensor:
        return self.layout.full(self.name, self.block)


def _gathered(t):
    return t.gather() if isinstance(t, _Whole) else t


def _sharded_tree(state, whole: bool) -> dict:
    """A sharded train state as the reference's tree (`params`, `opt`,
    `step`, and `err` with `compress_pod_grads`): of `_Whole` leaves, or
    of this rank's blocks."""
    model = state["params"]
    layout = model.layout

    def tree(values: dict) -> dict:
        if whole:
            values = {n: _Whole(layout, n, t) for n, t in values.items()}
        return params_tree(model, values)

    out = {"params": tree(dict(model.named_parameters())),
           "opt": {k: tree(v) if isinstance(v, dict) else v
                   for k, v in state["opt"].items()},
           "step": state["step"]}
    if "err" in state:
        out["err"] = tree(state["err"])
    return out


def _tree(state, whole: bool = True) -> dict:
    """A dict state as a tree: a dense train state (its params a module)
    as the reference's tree over its tensors, any other dict as it is. A
    sharded state's tree holds its whole leaves (`whole`: gathered as
    they are copied) or this rank's blocks."""
    if _sharded(state):
        return _sharded_tree(state, whole)
    if isinstance(state.get("params"), torch.nn.Module):
        return train_state_tree(state)
    return state


def _dict_path(path: tuple) -> str:
    # the string of the reference's key path for a leaf of dicts (and
    # tuples: an int key is a tuple's index)
    keys = [f"SequenceKey(idx={k})" if isinstance(k, int)
            else f"DictKey(key='{k}')" for k in path]
    return f"({keys[0]},)" if len(keys) == 1 else f"({', '.join(keys)})"


def _named_leaves(state) -> list[tuple[str, object]]:
    """(manifest path, leaf) in the reference's order. The paths are the
    strings the reference's manifest holds, so both packages write the
    same manifest for one state: a dict tree's key paths (sorted keys), a
    NamedTuple's fields by name, any other sequence by index (its leaves
    replicated)."""
    if isinstance(state, dict):
        return [(_dict_path(path), leaf)
                for path, leaf in tree_leaves(_tree(state))]
    names = getattr(state, "_fields", None)
    if names is None:
        return [(f"[{i}]", leaf) for i, leaf in enumerate(state)]
    return [(f"(GetAttrKey(name='{name}'),)", leaf)
            for name, leaf in zip(names, state, strict=True)]


def _as_tensor(leaf):
    """A leaf as a detached tensor, or a list of them (a stacked leaf)."""
    if isinstance(leaf, list):
        return [t.detach() for t in leaf]
    if isinstance(leaf, _Whole):
        return leaf
    if not torch.is_tensor(leaf):
        leaf = torch.as_tensor(np.asarray(leaf))
    return leaf.detach()


def _shape(leaf) -> list[int]:
    if isinstance(leaf, list):
        return [len(leaf), *leaf[0].shape]
    return list(leaf.shape)


def _first(leaf) -> torch.Tensor:
    return leaf[0] if isinstance(leaf, list) else leaf


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._buffers: dict[int, torch.Tensor] = {}

    # -- save ---------------------------------------------------------------

    def _snapshot(self, i: int, leaf) -> torch.Tensor:
        """Copy `leaf` (a tensor, or a list of them stacked) into leaf i's
        kept host buffer, `non_blocking` on the current stream when it is
        on the card."""
        first, shape = _first(leaf), torch.Size(_shape(leaf))
        buf = self._buffers.get(i)
        pinned = first.is_cuda
        if buf is None or buf.shape != shape or buf.dtype != first.dtype \
                or buf.is_pinned() != pinned:
            buf = self._buffers[i] = torch.empty(
                shape, dtype=first.dtype, pin_memory=pinned)
        if isinstance(leaf, list):
            for part, t in zip(buf, leaf, strict=True):
                part.copy_(_gathered(t), non_blocking=pinned)
        else:
            buf.copy_(_gathered(leaf), non_blocking=pinned)
        return buf

    def save(self, step: int, state, extra: dict | None = None,
             block: bool = True, mesh=None):
        """Snapshot `state` (a `DPMRState`, a dense train state or another
        dict tree, or a sequence of tensors or arrays) at `step`. With a
        `mesh` of P > 1 ranks the `SHARDED` fields of a `DPMRState` are
        this rank's blocks and are gathered whole (every rank must call
        this).

        The device->host copies are enqueued HERE, on the current stream:
        that is the snapshot point, and later in-place updates of the
        state run after them. Everything after (the wait on the copies,
        np.save, the manifest's fsync, the atomic renames, GC) runs inline
        (`block=True`) or on a thread."""
        self.wait()
        fields = getattr(state, "_fields", ())
        leaves = []
        for i, (path, leaf) in enumerate(_named_leaves(state)):
            leaf = _as_tensor(leaf)
            if fields and fields[i] in SHARDED and mesh is not None \
                    and int(mesh.size()) > 1:
                whole = leaf.new_empty((int(mesh.size()) * leaf.shape[0],
                                        *leaf.shape[1:]))
                dist.all_gather_into_tensor(whole, leaf.contiguous())
                leaf = whole
            leaves.append((path, leaf))
        manifest = {
            "step": int(step),
            "num_leaves": len(leaves),
            "paths": [path for path, _ in leaves],
            "shapes": [_shape(t) for _, t in leaves],
            "dtypes": [str(torch.empty(0, dtype=_first(t).dtype).numpy()
                           .dtype) for _, t in leaves],
            "extra": extra or {},
            "time": time.time(),
        }
        if not multiprocess.is_primary():
            for _, leaf in leaves:      # a sharded state's gathers, in order
                for t in leaf if isinstance(leaf, list) else [leaf]:
                    _gathered(t)
            if block:
                multiprocess.barrier()
            return      # the gathers were the collective part
        host = [self._snapshot(i, t) for i, (_, t) in enumerate(leaves)]
        copied = None
        cuda = [_first(t).device for _, t in leaves if _first(t).is_cuda]
        if cuda:
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(cuda[0]))

        def _write():
            if copied is not None:
                copied.synchronize()
            final = os.path.join(self.dir, f"step_{step:010d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for i, buf in enumerate(host):
                np.save(os.path.join(tmp, f"arr_{i}.npy"), buf.numpy())
            # manifest last, via its own temp + replace: its presence (and
            # parseability) is the completeness marker readers trust
            mtmp = os.path.join(tmp, "manifest.json.tmp")
            with open(mtmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, os.path.join(tmp, "manifest.json"))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if block:
            _write()
            multiprocess.barrier()
            return

        def _run():
            try:
                _write()
            except BaseException as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    def wait(self):
        """Join the in-flight async write, raising what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}", "manifest.json")

    def _manifest_ok(self, step: int) -> bool:
        try:
            with open(self._manifest_path(step)) as f:
                json.load(f)
            return True
        except (OSError, ValueError):
            return False

    def all_steps(self) -> list[int]:
        """Steps with a COMPLETE checkpoint (parseable manifest). A dir
        whose manifest is missing or truncated (a crashed writer, a
        partial copy) is skipped, so `restore()` falls back to the newest
        good step instead of crashing on the bad one."""
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    step = int(name[5:])
                except ValueError:
                    continue
                if self._manifest_ok(step):
                    out.append(step)
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_host(self, step: int | None = None
                     ) -> tuple[list[np.ndarray], dict]:
        """Raw host-side leaves + manifest, no placement: the elastic
        path. When the saved geometry no longer matches the live state
        (`shapes` differ), re-pad these with `runtime/elastic.py` instead
        of cutting them blind."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with open(self._manifest_path(step)) as f:
            manifest = json.load(f)
        d = os.path.join(self.dir, f"step_{step:010d}")
        arrs = [np.load(os.path.join(d, f"arr_{i}.npy"))
                for i in range(manifest["num_leaves"])]
        return arrs, manifest

    def restore(self, like, step: int | None = None, mesh=None):
        """Restore into the structure of `like`: a `DPMRState` on its
        device (this rank's blocks of the saved full arrays on `mesh`), or
        a dense train state or another dict tree of tensors, whose tensors
        take the saved arrays IN PLACE. Returns (state, manifest)."""
        arrs, manifest = self.restore_host(step)
        if isinstance(like, dict):
            return _restore_tree(like, arrs, manifest), manifest
        if len(arrs) != len(like):
            raise ValueError(f"checkpoint has {len(arrs)} leaves, the "
                             f"state {len(like)}")
        return state_from_numpy(arrs, like[0].device, mesh), manifest


def _restore_tree(like: dict, arrs: list, manifest: dict) -> dict:
    leaves = _named_leaves(like)        # a sharded state's: whole, lazy
    paths = [path for path, _ in leaves]
    if paths != manifest["paths"]:
        raise ValueError(f"the checkpoint's leaves {manifest['paths']} are "
                         f"not the state's {paths}")
    for (path, leaf), arr in zip(leaves, arrs, strict=True):
        if list(arr.shape) != _shape(leaf):
            raise ValueError(f"{path}: saved shape {list(arr.shape)}, "
                             f"the state's {_shape(leaf)}")
    if _sharded(like):
        from repro_torch.runtime.elastic import reshard_tree

        tree: dict = {}
        for (path, _), arr in zip(tree_leaves(_tree(like, whole=False)),
                                  arrs, strict=True):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = arr
        return reshard_tree(tree, like)
    with torch.no_grad():
        for (_, leaf), arr in zip(leaves, arrs, strict=True):
            parts = zip(leaf, arr) if isinstance(leaf, list) \
                else [(leaf, arr)]
            for t, a in parts:
                t.copy_(torch.as_tensor(a))
    return like


def manifest_extra(directory: str, step: int | None = None) -> dict:
    ck = Checkpointer(directory)
    step = ck.latest_step() if step is None else step
    with open(os.path.join(directory, f"step_{step:010d}",
                           "manifest.json")) as f:
        return json.load(f)["extra"]
