"""Sharded numpy checkpoints of the training state, one rank or several.

Port of ``repro.train.checkpoint`` in its v1 on-disk format, so each
package restores the other's files: one ``.npy`` a leaf and ``meta.json``
under ``<ckpt_dir>/step_%08d/``, the leaves numbered over the sorted flat
keys (``master/...``, ``opt_m/...``, ``opt_v/...``, ``primaries/...``,
``step``). bf16 is written as its uint16 bits and recorded as "bfloat16";
it is read back through an int16 view, so neither side needs ml_dtypes.

* One rank (the ``global`` format): ``leaf_0007.npy`` holds the global
  padded ``[stack,] pad`` array, which is that rank's whole shard.
* Several ranks (``per_process``): each rank is a process with one device
  and writes ``leaf_0007.p002.npy`` (rank 2's shard, stacked with a leading
  axis of 1); rank 0 writes ``meta.json`` with the mesh layout and the v1
  ``device_map`` (rank -> its mesh coordinates, and the process that holds
  it, which is the rank), then every rank meets at a barrier.

``restore`` checks the format version, the mesh layout (``MeshMismatch``;
strict on the mesh shape for ``per_process``) and the scheme fingerprint
(``SchemeMismatch``), with the reference's messages. The port checks the
mesh first: its scheme fingerprint also records the axis sizes, so a
restore onto another number of ranks names the layout rather than the
scheme. ``reshard=True`` (elastic restore, DESIGN.md §11) demotes both to
work: each leaf's shards are located through the writing run's device map
and scheme fingerprint (shard index = the writer's coordinates over the
category's axes, major to minor; replica copies read once), its alignment
padding is resized to the live engine's (zeros only: dropping nonzero
bits is refused) and this rank's columns of it are placed. A restore reads
one leaf at a time through ``np.load(mmap_mode="r")`` and copies only this
rank's columns, so no rank holds more than one global leaf on the host;
every tensor it returns is a fresh one on the engine's device, which the
engine owns (its step updates the state in place). ``check_layout`` runs
a strict restore's version and mesh checks with no engine (a launcher
refuses before it starts a rank); ``shard_digests`` gives the sha256 of
each shard a rank holds, to check a restore against the files.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

FORMAT_VERSION = 1

_OS_CATS = ("master", "opt_m", "opt_v")
_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _check_version(meta: dict, where: str):
    v = int(meta.get("version", 0))
    if v > FORMAT_VERSION:
        raise ValueError(
            f"{where} is checkpoint format v{v}, but this build reads "
            f"v{FORMAT_VERSION} and older. Upgrade the reader (or re-save "
            f"the checkpoint with a v{FORMAT_VERSION} writer).")


def _flatten(state, prefix=""):
    out = {}
    for k, v in state.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten(flat):
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _to_disk(v) -> tuple[np.ndarray, str]:
    """A state leaf on the host as it is written, and its recorded dtype:
    bf16 as its uint16 bits, the step as an int32. The copy to the host is
    done when this returns, so the next step may update the tensor."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v, np.int32), "int32"
    name = _DTYPES.get(v.dtype)
    if name is None:
        raise ValueError(f"cannot checkpoint a {v.dtype} tensor")
    t = v.detach().contiguous()
    if name == "bfloat16":
        return t.view(torch.int16).cpu().numpy().view(np.uint16), name
    return t.cpu().numpy(), name


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# -- mesh layout identity ----------------------------------------------------

def mesh_layout(mesh) -> dict:
    """JSON-serializable identity of a mesh's device/process layout: a rank
    is a process with one device."""
    return dict(axes=list(mesh.axis_names),
                shape=[int(mesh.shape[a]) for a in mesh.axis_names],
                n_devices=int(mesh.size), process_count=int(mesh.size),
                local_devices=1)


def _device_map(mesh) -> dict:
    """v1 meta: rank -> its mesh coordinates (``meta["mesh"]["axes"]``
    order) and the process that holds it (itself)."""
    coords = {str(r): [mesh._coords(r)[a] for a in mesh.axis_names]
              for r in range(mesh.size)}
    return dict(coords=coords, process={str(r): r for r in range(mesh.size)})


class MeshMismatch(ValueError):
    """Checkpoint device/process layout does not match the restoring mesh."""


def _fmt_layout(d: dict) -> str:
    return (f"{dict(zip(d.get('axes', []), d.get('shape', [])))} "
            f"({d.get('n_devices')} devices, {d.get('process_count')} "
            f"process(es) x {d.get('local_devices')} local)")


def _layout_differs(saved: dict | None, live: dict,
                    strict_shape: bool = False) -> bool:
    if saved is None:
        return False     # a checkpoint without mesh metadata
    return (saved.get("n_devices") != live["n_devices"]
            or saved.get("process_count") != live["process_count"]
            or saved.get("local_devices") != live["local_devices"]
            or (strict_shape and (saved.get("axes") != live["axes"]
                                  or saved.get("shape") != live["shape"])))


def _check_mesh(saved: dict | None, live: dict, where: str,
                strict_shape: bool = False):
    if _layout_differs(saved, live, strict_shape):
        raise MeshMismatch(
            f"{where} was written on a different mesh layout:\n"
            f"  checkpoint: {_fmt_layout(saved)}\n"
            f"  restoring : {_fmt_layout(live)}\n"
            "Shard files are laid out per device/process, so they cannot be "
            "re-placed directly across layouts. Restore with reshard=True "
            "(the Trainer/--resume default) to route each leaf through the "
            "partition formulas onto this mesh, or relaunch with the "
            "checkpoint's process/device count.")


# -- save --------------------------------------------------------------------

def save(state, ckpt_dir, step: int, scheme: dict | None = None, *,
         engine):
    """Write ``state``, this rank's shards of ``engine``'s state, as step
    ``step``; returns the step's directory. ``scheme``: the writing
    engine's ``scheme_fingerprint()``, recorded so a restore under another
    partitioning fails loudly. On several ranks every rank calls this."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    flat = _flatten(state)
    mesh = engine.mesh
    multi = mesh.size > 1
    d.mkdir(parents=True, exist_ok=True)

    names, dtypes, shapes = {}, {}, {}
    for i, (k, v) in enumerate(sorted(flat.items())):
        base = f"leaf_{i:04d}"
        arr, dtypes[k] = _to_disk(v)
        if not multi:
            shapes[k] = list(arr.shape)
            np.save(d / f"{base}.npy", arr)
            names[k] = f"{base}.npy"
            continue
        # per-process: this rank's shard, stacked over its one device
        shapes[k] = [] if k == "step" else \
            list(arr.shape[:-1]) + [engine._pad[k.split("/", 1)[1]]]
        np.save(d / f"{base}.p{mesh.rank:03d}.npy", arr[None])
        names[k] = base          # per-process files share the base name

    if mesh.rank == 0:
        meta = dict(version=FORMAT_VERSION, step=step, names=names,
                    dtypes=dtypes, global_shapes=shapes,
                    format="per_process" if multi else "global",
                    mesh=mesh_layout(mesh), device_map=_device_map(mesh))
        if scheme is not None:
            meta["scheme"] = scheme
        (d / "meta.json").write_text(json.dumps(meta))
    if multi:
        dist.barrier()
    return str(d)


# -- scheme guard (layout identity below the mesh: degrees, padding) ---------

class SchemeMismatch(ValueError):
    """Checkpoint layout does not match the restoring engine's scheme."""


def _check_scheme(saved: dict | None, expect: dict, where: str):
    # normalize through JSON so tuples/lists and int/float compare equal
    expect = json.loads(json.dumps(expect))
    if saved is None:
        raise SchemeMismatch(
            f"{where} has no scheme metadata (written before scheme "
            f"recording, or by an external tool); refusing to restore into "
            f"an engine expecting {expect['scheme']!r}. Re-save the "
            f"checkpoint with a scheme fingerprint, or restore with "
            f"expect_scheme=None to skip the check at your own risk.")
    if saved != expect:
        diffs = []
        for k in sorted(set(saved) | set(expect)):
            if saved.get(k) != expect.get(k):
                diffs.append(f"  {k}: checkpoint={saved.get(k)!r} "
                             f"engine={expect.get(k)!r}")
        raise SchemeMismatch(
            f"{where} was written under a different partitioning scheme — "
            f"restoring it here would silently place shards in the wrong "
            f"layout. Mismatched fields:\n" + "\n".join(diffs) +
            "\nRebuild the engine with the checkpoint's scheme/mesh, or "
            "re-shard the checkpoint explicitly.")


def latest_step(ckpt_dir) -> int | None:
    steps = sorted(int(p.name.split("_")[1])
                   for p in Path(ckpt_dir).glob("step_*"))
    return steps[-1] if steps else None


def _meta(d: Path) -> dict:
    meta = json.loads((d / "meta.json").read_text())
    _check_version(meta, str(d))
    return meta


def check_layout(ckpt_dir, step: int, mesh):
    """``restore(reshard=False)``'s version and mesh checks alone, against
    ``mesh`` (no engine and no process group needed), so a launcher can
    refuse a strict restore onto another layout before it starts a rank."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    meta = _meta(d)
    _check_mesh(meta.get("mesh"), mesh_layout(mesh), str(d),
                meta.get("format", "global") == "per_process")


def shard_digests(state) -> dict:
    """The sha256 of every tensor leaf's bytes as this rank holds it, and
    its shape, by flat key (``primaries/...``, ``master/...``): what a
    restored state can be checked against, e.g. the same columns read
    from the checkpoint's files."""
    out = {}
    for k, v in sorted(_flatten(state).items()):
        if isinstance(v, torch.Tensor):
            b = v.detach().contiguous().view(torch.uint8).cpu().numpy()
            out[k] = dict(sha256=hashlib.sha256(b).hexdigest(),
                          shape=list(v.shape))
    return out


# -- reading leaves ------------------------------------------------------------

def _category_axes(key: str, scheme: dict) -> list[str]:
    """Mesh axes (major -> minor) the saved leaf was sharded over, from the
    WRITING engine's scheme fingerprint."""
    cat = key.split("/", 1)[0]
    ax = scheme["axes"]
    if cat == "primaries":
        return list(ax["weight"])
    if cat in _OS_CATS:
        return list(ax["weight"]) + list(ax["extra_grad"]) + list(ax["replica"])
    return []            # step and anything unknown: replicated


def _global_chunks(d: Path, base: str, k: str, meta: dict) -> list:
    """A per-process leaf's global array as its shards along the last axis,
    in order (memory-mapped: nothing is read yet).

    Each shard's position comes from the v1 device map and the saved
    scheme's partition axes: device coords -> shard index along the last
    (flat padded) dim, major to minor over the category's axis tuple. A
    file may hold any number of shards (its process's devices, in
    device-id order); a shard's replicas are read once."""
    scheme, dmap = meta.get("scheme"), meta.get("device_map")
    if scheme is None or dmap is None:
        raise MeshMismatch(
            f"{d / base}: per-process checkpoint predates format "
            f"v{FORMAT_VERSION} (no scheme/device_map in meta.json) — it "
            "cannot be resharded across layouts. Restore it on the writing "
            f"layout ({_fmt_layout(meta.get('mesh', {}))}) and re-save.")
    mesh_meta = meta["mesh"]
    sizes = dict(zip(mesh_meta["axes"], mesh_meta["shape"]))
    axis_pos = {a: i for i, a in enumerate(mesh_meta["axes"])}
    axes = _category_axes(k, scheme)
    n_shards = int(np.prod([sizes[a] for a in axes])) if axes else 1

    by_proc: dict[int, list[int]] = {}
    for did, p in dmap["process"].items():
        by_proc.setdefault(int(p), []).append(int(did))
    chunks: list = [None] * n_shards
    for pid, ids in sorted(by_proc.items()):
        path = d / f"{base}.p{pid:03d}.npy"
        if not path.exists():
            raise MeshMismatch(
                f"{path} missing: resharding needs every writing process's "
                f"shard file visible on a shared filesystem "
                f"({_fmt_layout(mesh_meta)})")
        stack = np.load(path, mmap_mode="r")
        ids = sorted(ids)            # save() stacks in device-id order
        if len(ids) != stack.shape[0]:
            raise MeshMismatch(
                f"{path} holds {stack.shape[0]} shards but the device map "
                f"assigns {len(ids)} devices to process {pid}")
        for row, did in enumerate(ids):
            coords = dmap["coords"][str(did)]
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + int(coords[axis_pos[a]])
            if chunks[idx] is None:  # replicas of a shard are identical
                chunks[idx] = stack[row]
    missing = [i for i, c in enumerate(chunks) if c is None]
    if missing:
        raise MeshMismatch(f"{d / base}: shard indices {missing} missing "
                           "from the per-process files")
    return chunks


def _columns(chunks: list, lo: int, hi: int) -> np.ndarray:
    """Columns [lo, hi) of the chunks laid end to end along the last axis,
    zero past their end, as a fresh array."""
    first = chunks[0]
    out = np.zeros(first.shape[:-1] + (hi - lo,), dtype=first.dtype)
    at = 0
    for c in chunks:
        a, b = max(lo, at), min(hi, at + c.shape[-1])
        if a < b:
            out[..., a - lo:b - lo] = c[..., a - at:b - at]
        at += c.shape[-1]
    return out


def _check_fit(chunks: list, k: str, saved: tuple, want: tuple):
    """The checkpoint's leaf may be resized to ``want`` only along its
    padded flat dim, and shrunk only over zeros: the alignment padding is
    exactly zero for the whole training state (zero-init beyond the
    logical slice, zero grads there, decay of zero stays zero)."""
    if saved == want:
        return
    if len(saved) != len(want) or saved[:-1] != want[:-1]:
        raise ValueError(
            f"{k}: checkpoint leaf shape {saved} cannot be resharded to "
            f"{want} — only the padded flat dim may differ (is this the "
            "same model?)")
    if saved[-1] > want[-1]:
        tail = _columns(chunks, want[-1], saved[-1])
        if np.any(tail.view(_UINT[tail.dtype.itemsize])):
            raise ValueError(
                f"{k}: truncating the padded dim {saved[-1]} -> "
                f"{want[-1]} would drop nonzero data — the checkpoint's "
                "padding is not clean (not written by this engine?)")


def _check_leaf_names(meta: dict, pads: dict | None, where: str):
    if not pads:
        return
    saved = {k.split("/", 1)[1] for k in meta["names"]
             if k.startswith("primaries/")}
    if saved and saved != set(pads):
        missing = sorted(set(pads) - saved)[:4]
        extra = sorted(saved - set(pads))[:4]
        raise SchemeMismatch(
            f"{where} holds a different model's leaves — resharding maps "
            f"layouts, not architectures. Engine-only: {missing}; "
            f"checkpoint-only: {extra}")


def _target_shape(key: str, meta: dict, pads: dict | None) -> tuple:
    """Global shape this leaf must have under the restoring engine: the
    same logical content, its padding resized to ``pads``."""
    saved = tuple(meta["global_shapes"][key])
    cat, _, name = key.partition("/")
    if not pads or cat not in ("primaries",) + _OS_CATS or name not in pads:
        return saved
    return saved[:-1] + (int(pads[name]),)


# -- restore -----------------------------------------------------------------

def restore(ckpt_dir, step: int, engine, expect_scheme: dict | None = None,
            *, reshard: bool = False):
    """The state of step ``step``, as this rank of ``engine`` holds it: the
    live engine takes the place of the reference's shardings.

    ``expect_scheme``: the restoring engine's ``scheme_fingerprint()``;
    when given (and ``reshard=False``) the saved one must match exactly or
    ``SchemeMismatch`` names the differing fields. The mesh layout must
    match the writer's, where it recorded one (``MeshMismatch``). ``reshard=True``
    demotes both checks: the leaves are read through the writer's device
    map and scheme, their padding resized to the engine's, and this rank's
    columns placed. When nothing differs it reads this rank's own files,
    so ``reshard=True`` is safe as a default."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    meta = _meta(d)
    fmt = meta.get("format", "global")
    mesh = engine.mesh
    live, strict = mesh_layout(mesh), fmt == "per_process"
    layout_differs = False
    if reshard:
        layout_differs = _layout_differs(meta.get("mesh"), live, strict)
    else:
        _check_mesh(meta.get("mesh"), live, str(d), strict)

    scheme_differs = False
    if expect_scheme is not None:
        if reshard:
            saved_scheme = meta.get("scheme")
            norm = json.loads(json.dumps(expect_scheme))
            scheme_differs = saved_scheme is not None and saved_scheme != norm
        else:
            _check_scheme(meta.get("scheme"), expect_scheme, str(d))

    pads = engine._pad
    shapes_differ = False
    if reshard:
        _check_leaf_names(meta, (expect_scheme or {}).get("padded_sizes")
                          or pads, str(d))
        shapes_differ = any(_target_shape(k, meta, pads)
                            != tuple(meta["global_shapes"][k])
                            for k in meta["names"])
    elastic = reshard and (layout_differs or scheme_differs or shapes_differ)

    flat = {}
    for k, fname in meta["names"].items():
        dtype = meta.get("dtypes", {}).get(k)
        own = fmt == "per_process" and not elastic
        if own:
            path = d / f"{fname}.p{mesh.rank:03d}.npy"
            if not path.exists():
                raise MeshMismatch(
                    f"{path} missing: this process has no shard file — the "
                    f"checkpoint was written by a different process layout "
                    f"({_fmt_layout(meta.get('mesh', {}))})")
            stack = np.load(path, mmap_mode="r")
            if stack.shape[0] != 1:
                raise MeshMismatch(
                    f"{path} holds {stack.shape[0]} shards but this process "
                    f"owns 1 device of the restoring mesh "
                    f"({_fmt_layout(mesh_layout(mesh))})")
            chunks = [stack[0]]       # this rank's shard, as it was written
        elif fmt == "per_process":
            chunks = _global_chunks(d, fname, k, meta)
        else:
            chunks = [np.load(d / fname, mmap_mode="r")]
        if k == "step":
            flat[k] = int(chunks[0])
            continue
        saved = tuple(meta["global_shapes"][k])
        want = _target_shape(k, meta, pads) if elastic else saved
        if elastic:
            _check_fit(chunks, k, saved, want)
        cat, _, name = k.partition("/")
        lo, hi = engine.shard_cols(name, cat)
        held = chunks[0].shape[-1] if own else hi - lo
        if want[-1] != pads[name] or held != hi - lo:
            raise SchemeMismatch(
                f"{d}: {k} is {want[-1]} wide, in shards of {held}; this "
                f"engine holds {hi - lo} of {pads[name]}. Restore with "
                "reshard=True to re-place it.")
        if own:
            lo, hi = 0, held
        flat[k] = _to_torch(_columns(chunks, lo, hi), dtype).to(engine.device)
    if mesh.size > 1:
        dist.barrier()
    return _unflatten(flat)
