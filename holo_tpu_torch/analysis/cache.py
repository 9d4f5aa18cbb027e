"""The kernel-contract audit behind a per-kernel cache: the audit arm of
``holo_tpu/analysis/cache.py`` and of its ``self_check``.

A program's findings depend on its registering module's bytes, the audit
machinery and its spec signature, and not on the other programs.  So the
cache is per kernel: fingerprint = sha256 of (registering module bytes,
audit machinery bytes, spec signature).  A fully warm tree (every recorded
file validates byte for byte: mtime and size, else sha256) replays the
stored :class:`~holo_tpu_torch.analysis.kernel_audit.AuditResult` without
running any program and without importing torch.  Otherwise the registry is
loaded, the programs whose fingerprints still match replay their stored
rows, the rest run, and the cache is rewritten.  The cache serves the CPU
audit only (``.holo_torch_audit_cache.json`` at the repo root): a run on the
card always runs every program.

:func:`self_check` runs the cached audit and a cold one back to back and
diffs the rendered findings: the loud failure that proves the replay equals
a real run.  Standard library only at import time.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

from holo_tpu_torch.analysis.core import Finding

# Bump when the cache document layout changes (readers reject other
# versions and run cold).
AUDIT_CACHE_VERSION = 1


def default_audit_cache_path(root: Path) -> Path:
    return Path(root) / ".holo_torch_audit_cache.json"


def _audit_infra_paths() -> list[Path]:
    """The audit machinery whose bytes feed every kernel fingerprint."""
    pkg = Path(__file__).resolve().parent
    return [pkg / "core.py", pkg / "kernels.py", pkg / "kernel_audit.py",
            pkg / "rules_kernel.py"]


def _finding_doc(f: Finding) -> dict:
    return {
        "rule": f.rule,
        "path": f.path,
        "line": f.line,
        "context": f.context,
        "message": f.message,
        "severity": f.severity,
    }


def _finding_from(d: dict) -> Finding:
    return Finding(
        rule=d["rule"],
        path=d["path"],
        line=int(d["line"]),
        context=d["context"],
        message=d["message"],
        severity=d.get("severity", "error"),
    )


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _audit_result_doc(result) -> dict:
    return {
        "findings": [_finding_doc(f) for f in result.findings],
        "suppressed": [_finding_doc(f) for f in result.suppressed],
        "kernel_seconds": dict(result.kernel_seconds),
        "kernels_checked": result.kernels_checked,
        "skipped": list(result.skipped),
        "device_count": result.device_count,
    }


def _audit_result_from(d: dict):
    from holo_tpu_torch.analysis.kernel_audit import AuditResult

    result = AuditResult(
        findings=[_finding_from(x) for x in d["findings"]],
        suppressed=[_finding_from(x) for x in d["suppressed"]],
        kernel_seconds=dict(d.get("kernel_seconds", {})),
        kernels_checked=int(d.get("kernels_checked", 0)),
        skipped=list(d.get("skipped", [])),
        device_count=int(d.get("device_count", 0)),
    )
    result.kernels_cached = result.kernels_checked
    return result


def _load_audit_doc(path: Path) -> dict | None:
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("version") != AUDIT_CACHE_VERSION:
        return None
    return doc


def _save(path: Path, doc: dict) -> None:
    try:
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(doc) + "\n")
        tmp.replace(path)
    except OSError:
        # Read-only checkout / parallel writer: the cache is an
        # optimization, never a correctness dependency.
        pass


def _validate_file_entries(entries: dict, root: Path) -> bool:
    """mtime/size -> sha256 ladder over a recorded file map (no refresh)."""
    for rel, ent in entries.items():
        p = root / rel
        try:
            st = p.stat()
        except OSError:
            return False
        if st.st_mtime_ns == ent["mtime_ns"] and st.st_size == ent["size"]:
            continue
        try:
            if _sha256(p.read_bytes()) == ent["sha256"]:
                continue
        except OSError:
            return False
        return False
    return True


def _file_entry(p: Path) -> dict | None:
    try:
        st = p.stat()
        data = p.read_bytes()
    except OSError:
        return None
    return {
        "mtime_ns": st.st_mtime_ns,
        "size": st.st_size,
        "sha256": _sha256(data),
    }


def run_audit_cached(root: Path, cache_path: Path | None = None, no_cache: bool = False):
    """The CPU kernel-contract audit behind the per-kernel cache.

    Fully warm (every file the last run depended on validates): replay the
    stored result without importing torch.  Otherwise run the audit, reuse
    the kernels whose fingerprints still match, run the rest, and rewrite
    the cache.  ``no_cache=True`` bypasses both read and write (every
    program runs)."""
    root = Path(root)
    cache_path = cache_path or default_audit_cache_path(root)
    doc = None if no_cache else _load_audit_doc(cache_path)

    if doc is not None and doc.get("files") and _validate_file_entries(doc["files"], root):
        return _audit_result_from(doc["result"])

    from holo_tpu_torch.analysis import kernel_audit

    entries = kernel_audit.load_registry()

    infra = hashlib.sha256()
    files: dict[str, dict] = {}
    for p in _audit_infra_paths():
        ent = _file_entry(p)
        try:
            rel = p.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:  # audit run against a root outside the repo
            rel = p.name
        if ent is not None:
            files[rel] = ent
            infra.update(ent["sha256"].encode())
    infra_hash = infra.hexdigest()

    module_hash: dict[str, str] = {}
    for entry in entries.values():
        if entry.module in module_hash:
            continue
        ent = _file_entry(root / entry.module)
        if ent is None:
            module_hash[entry.module] = ""
            continue
        files[entry.module] = ent
        module_hash[entry.module] = ent["sha256"]

    def fingerprint(name: str, signature: str) -> str:
        module = module_hash.get(entries[name].module, "")
        return _sha256((module + infra_hash + signature).encode())

    # Only a partly valid cache needs the fingerprints before the run (its
    # specs built once more); a cold run takes them from the specs it ran.
    reuse: dict[str, dict] = {}
    fingerprints: dict[str, str] = {}
    if doc is not None:
        fingerprints = {name: fingerprint(name, kernel_audit.spec_signature(entry))
                        for name, entry in entries.items()}
        for name, row in doc.get("kernels", {}).items():
            if name in fingerprints and row.get("fingerprint") == fingerprints[name]:
                reuse[name] = {
                    "findings": [_finding_from(x) for x in row.get("raw", [])],
                    "seconds": row.get("seconds", 0.0),
                }

    result = kernel_audit.run_audit(str(root), reuse=reuse)

    if not no_cache:
        for name, signature in result.kernel_signatures.items():
            fingerprints.setdefault(name, fingerprint(name, signature))
        kernels_doc = {
            name: {
                "fingerprint": fingerprints.get(name, ""),
                "raw": [_finding_doc(f) for f in rows],
                "seconds": result.kernel_seconds.get(name, 0.0),
            }
            for name, rows in result.kernel_findings.items()
        }
        _save(
            cache_path,
            {
                "version": AUDIT_CACHE_VERSION,
                "files": files,
                "kernels": kernels_doc,
                "result": _audit_result_doc(result),
            },
        )
    return result


def self_check(root: Path, cache_path: Path | None = None) -> list[str]:
    """Prove the cache replays exactly what a real audit produces: the
    cached run, then a cold one, their findings, suppressed findings and
    skipped kernels rendered and diffed.  Returns human-readable mismatch
    lines; empty means the cache is faithful."""
    from holo_tpu_torch.analysis.kernel_audit import run_audit

    warm = run_audit_cached(root, cache_path=cache_path)
    fresh = run_audit(str(root))

    def view(result) -> list[str]:
        lines = [f.render() for f in result.findings]
        lines += [f"suppressed: {f.render()}" for f in result.suppressed]
        lines += [f"skipped: {name}" for name in sorted(result.skipped)]
        return lines

    a, b = view(warm), view(fresh)
    out: list[str] = []
    if a != b:
        for line in b:
            if line not in a:
                out.append(f"audit cold only: {line}")
        for line in a:
            if line not in b:
                out.append(f"audit cached replay only: {line}")
        if not out:
            out.append("audit finding order diverged between cached and cold runs")
    return out
