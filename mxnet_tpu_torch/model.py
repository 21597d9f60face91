"""Checkpoints and the updater loop of the Module API (counterpart of
``mxnet_tpu/model.py``: ``BatchEndParam``, ``_create_kvstore`` :27-49,
``_update_params`` :83, ``save_checkpoint``/``load_checkpoint``
:98-131, the checkpoint manifest :134-338).

Only what ``Module`` needs on one device.  No kvstore exists on one device
(``_create_kvstore`` gives ``None``, as the JAX package's does there); a
``dist`` store, or a ``KVStore`` object, raises until ROADMAP queue 1 #8
ports ``kvstore.py``.  A checkpoint is ``prefix-symbol.json`` and
``prefix-%04d.params`` with ``arg:``/``aux:`` keys, in the bytes both
packages read (``nd.save``).

Crash consistency, as in the JAX package: every file is written with
``util.write_atomic``, and only then is the checkpoint committed into
``prefix-manifest.json`` with each file's sha256.  The manifest's JSON is
byte for byte the JAX package's for the same files, so either package's
:func:`latest_complete_checkpoint` finds the other's checkpoints, and a
deployment watcher (``serving/deploy.py``) never stages a torn one.
``fit(resume_from=, auto_resume=)`` is not ported yet.
"""
from __future__ import annotations

import logging
from collections import namedtuple

from .base import MXNetError

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_manifest", "record_checkpoint", "checkpoint_files",
           "latest_complete_checkpoint", "prune_checkpoints"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore): ``(None, False)`` for one device and
    no ``dist`` store, which is all the port has."""
    if kvstore is None:
        return (None, False)
    if isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            return (None, False)
    raise MXNetError(
        "kvstore %r needs a KVStore, which is not ported yet (ROADMAP "
        "queue 1 #8); train on one device with kvstore='local' or None"
        % (kvstore,))


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The local updater over each device copy (``model.py:83``); the
    updater takes the arrays' tensors and updates them in place."""
    if kvstore:
        raise MXNetError("kvstore updates are not ported yet (ROADMAP queue "
                         "1 #8)")
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays, grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(i * num_device + k, g._data, w._data)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params``, each atomically, then commit them into
    ``prefix-manifest.json`` (:func:`record_checkpoint`): a crash at any
    point leaves the manifest naming only complete checkpoints."""
    from .ndarray import utils
    files = []
    if symbol is not None:
        symbol_file = "%s-symbol.json" % prefix
        symbol.save(symbol_file)
        files.append(symbol_file)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    utils.save(param_name, save_dict)
    files.append(param_name)
    record_checkpoint(prefix, epoch, files)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch, ctx=None):
    """(symbol, arg_params, aux_params) of a checkpoint; the arrays load
    onto ``ctx`` (default the current context)."""
    from . import symbol as sym
    from .ndarray import utils
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = utils.load("%s-%04d.params" % (prefix, epoch), ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return (symbol, arg_params, aux_params)


# ---------------------------------------------------------------------------
# the checkpoint manifest: which epochs are complete, with content hashes
# ---------------------------------------------------------------------------
# ``<prefix>-manifest.json``:
#   {"version": 1,
#    "checkpoints": {"7": {"files": {"<path>": "<sha256 hex>", ...}}}}
# Keys are epochs as strings; paths are as written (relative to the
# caller's working directory, as every prefix-derived path here).  The
# manifest is written atomically, after the files it records: it is the
# commit record of the save.

def _manifest_path(prefix):
    return "%s-manifest.json" % prefix


def _dump_manifest(manifest):
    import json
    return json.dumps(manifest, indent=1, sort_keys=True)


def load_manifest(prefix):
    """The parsed manifest, or None (missing, torn or unreadable)."""
    import json
    try:
        with open(_manifest_path(prefix), "r") as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(manifest, dict) or \
            not isinstance(manifest.get("checkpoints"), dict):
        return None
    return manifest


def record_checkpoint(prefix, epoch, files):
    """Commit a written checkpoint into the manifest (an atomic rewrite).
    Each file is hashed as read back from disk: the hash is of what
    landed."""
    from .util import sha256_file, write_atomic
    manifest = load_manifest(prefix) or {"version": 1, "checkpoints": {}}
    manifest["checkpoints"][str(int(epoch))] = {
        "files": {f: sha256_file(f) for f in files}}
    write_atomic(_manifest_path(prefix), _dump_manifest(manifest))


def checkpoint_files(prefix, epoch):
    """The files the manifest records for ``epoch`` (path -> sha256), or
    None when it records no such epoch (or there is no manifest)."""
    manifest = load_manifest(prefix)
    if manifest is None:
        return None
    entry = manifest["checkpoints"].get(str(int(epoch)))
    return None if entry is None else dict(entry.get("files", {}))


def _checkpoint_intact(entry):
    """Does every file of a manifest entry exist with its recorded hash?"""
    from .util import sha256_file
    files = entry.get("files", {})
    if not files:
        return False
    for path, digest in files.items():
        try:
            if sha256_file(path) != digest:
                return False
        except OSError:
            return False
    return True


def latest_complete_checkpoint(prefix, allow_unverified=False):
    """The newest epoch whose checkpoint is verifiably complete, or None.

    Walks the manifest newest first and returns the first epoch whose
    recorded files all exist with their hashes, so a torn or uncommitted
    save is skipped.  Without a manifest the answer is None, unless
    ``allow_unverified=True``: then the newest ``prefix-%04d.params`` on
    disk that parses (with the symbol file, when present) is taken, a
    best-effort reading of checkpoints written before manifests.
    """
    manifest = load_manifest(prefix)
    if manifest is not None:
        for epoch in sorted((int(e) for e in manifest["checkpoints"]),
                            reverse=True):
            if _checkpoint_intact(manifest["checkpoints"][str(epoch)]):
                return epoch
        return None
    if not allow_unverified:
        return None
    import glob
    import os
    import re
    from . import symbol as sym
    from .ndarray import utils
    pattern = re.compile(re.escape(os.path.basename(prefix)) +
                         r"-(\d{4})\.params$")
    epochs = []
    for path in glob.glob("%s-*.params" % glob.escape(prefix)):
        m = pattern.search(os.path.basename(path))
        if m:
            epochs.append(int(m.group(1)))
    symbol_file = "%s-symbol.json" % prefix
    for epoch in sorted(epochs, reverse=True):
        try:
            utils.load_numpy("%s-%04d.params" % (prefix, epoch))
            if os.path.exists(symbol_file):
                sym.load(symbol_file)
            return epoch
        except Exception:
            continue
    return None


def prune_checkpoints(prefix, keep_last=2):
    """Keep the newest ``keep_last`` complete checkpoints of a manifest
    prefix; remove what the manifest has superseded and the temporary
    files (``<path>.tmp-<pid>-<tid>``) that killed writers left.

    The newest complete entry is never touched (``keep_last`` is at least
    1); entries newer than it stay even when torn (a save in progress
    elsewhere looks so); a file goes only when no kept entry records it;
    the manifest drops the pruned entries before their files go, so a
    crash mid-prune leaves it naming only files still there.  Returns
    ``{"kept": [epochs], "pruned": [epochs], "removed_files": [...],
    "removed_tmp": [...]}``.
    """
    import glob
    import os
    from .util import write_atomic
    keep_last = max(1, int(keep_last))
    report = {"kept": [], "pruned": [], "removed_files": [],
              "removed_tmp": []}
    manifest = load_manifest(prefix)
    if manifest is not None:
        entries = manifest["checkpoints"]
        epochs = sorted((int(e) for e in entries), reverse=True)
        complete = [e for e in epochs
                    if _checkpoint_intact(entries[str(e)])]
        kept = set(complete[:keep_last])
        if complete:
            newest_complete = complete[0]
            pruned = [e for e in epochs
                      if e < newest_complete and e not in kept]
        else:
            pruned = []
        if pruned:
            keep_files = set()
            for e in epochs:
                if e not in pruned:
                    keep_files.update(entries[str(e)].get("files", {}))
            remove_files = set()
            for e in pruned:
                remove_files.update(entries[str(e)].get("files", {}))
            remove_files -= keep_files
            for e in pruned:
                del entries[str(e)]
            write_atomic(_manifest_path(prefix), _dump_manifest(manifest))
            for path in sorted(remove_files):
                try:
                    os.remove(path)
                    report["removed_files"].append(path)
                except OSError:
                    pass
        report["kept"] = sorted(kept)
        report["pruned"] = sorted(pruned)
    # a completed write_atomic renames its temporary file away, so one
    # still on disk means its writer died before the commit
    for path in sorted(glob.glob("%s*.tmp-*" % glob.escape(prefix))):
        try:
            os.remove(path)
            report["removed_tmp"].append(path)
        except OSError:
            pass
    return report
