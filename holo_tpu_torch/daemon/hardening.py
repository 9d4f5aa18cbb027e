"""Daemon production hardening: single-instance flock, privilege drop
with retained network capabilities, and signal handling.

Reference: holo-daemon/src/main.rs — flock (28-57), privdrop + Linux
capabilities (159-187), signal listener (189-209).
"""

from __future__ import annotations

import ctypes
import errno
import fcntl
import logging
import os
import signal

log = logging.getLogger("holo_tpu_torch.hardening")

# Linux capability bits we must keep after dropping root (raw protocol
# sockets, netlink FIB programming, port 179/514 binds).
CAP_NET_BIND_SERVICE = 10
CAP_NET_ADMIN = 12
CAP_NET_RAW = 13
_KEEP_CAPS = (CAP_NET_BIND_SERVICE, CAP_NET_ADMIN, CAP_NET_RAW)

PR_SET_KEEPCAPS = 8
_LINUX_CAPABILITY_VERSION_3 = 0x20080522
SYS_CAPSET = 126  # x86_64


def acquire_instance_lock(path: str):
    """flock an instance lock file; returns the held fd or raises
    RuntimeError when another daemon owns it (main.rs:28-57)."""
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError as e:
        os.close(fd)
        if e.errno in (errno.EAGAIN, errno.EACCES):
            raise RuntimeError(
                f"another instance holds {path!r} — refusing to start"
            ) from e
        raise
    os.truncate(fd, 0)
    os.write(fd, str(os.getpid()).encode())
    return fd


def _capset(caps: tuple[int, ...]) -> None:
    """capset(2) via syscall: permitted+effective = the given bits."""
    libc = ctypes.CDLL(None, use_errno=True)

    class Header(ctypes.Structure):
        _fields_ = [("version", ctypes.c_uint32), ("pid", ctypes.c_int)]

    class Data(ctypes.Structure):
        _fields_ = [
            ("effective", ctypes.c_uint32),
            ("permitted", ctypes.c_uint32),
            ("inheritable", ctypes.c_uint32),
        ]

    lo = hi = 0
    for cap in caps:
        if cap < 32:
            lo |= 1 << cap
        else:
            hi |= 1 << (cap - 32)
    hdr = Header(_LINUX_CAPABILITY_VERSION_3, 0)
    data = (Data * 2)(Data(lo, lo, 0), Data(hi, hi, 0))
    if libc.syscall(SYS_CAPSET, ctypes.byref(hdr), ctypes.byref(data)) != 0:
        raise OSError(ctypes.get_errno(), "capset failed")


def drop_privileges(user: str) -> None:
    """setuid/setgid to ``user`` keeping the network capabilities
    (main.rs:159-187).  No-op when not running as root."""
    if os.geteuid() != 0:
        return
    import pwd

    ent = pwd.getpwnam(user)
    libc = ctypes.CDLL(None, use_errno=True)
    # Keep permitted capabilities across the uid change...
    if libc.prctl(PR_SET_KEEPCAPS, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_KEEPCAPS) failed")
    os.setgroups([])
    os.setgid(ent.pw_gid)
    os.setuid(ent.pw_uid)
    # ...then re-enable the effective set (cleared by setuid).
    _capset(_KEEP_CAPS)
    log.info(
        "privileges dropped to %s (kept NET_ADMIN/NET_RAW/NET_BIND)", user
    )


def install_signal_handlers(shutdown_cb, dump_cb=None, postmortem_cb=None) -> None:
    """SIGINT/SIGTERM -> orderly shutdown; SIGHUP ignored (config is
    transactional via the northbound, not file reload); SIGUSR1 ->
    runtime-introspection dump to the log when ``dump_cb`` is given.

    ``postmortem_cb`` runs first in the handler (flight-recorder bundle
    capture), before the orderly shutdown starts, so the bundle survives a
    teardown that hangs.  (``holo_tpu``'s ``flush_cb``, which syncs the
    event recorder's journal before it, has no use here: the recorder is
    not ported.)"""

    def _handler(signum, _frame):
        log.info("signal %s: shutting down", signal.Signals(signum).name)
        if postmortem_cb is not None:
            try:
                postmortem_cb()
            except Exception:  # forensics must not block the shutdown
                log.exception("shutdown postmortem failed")
        shutdown_cb()

    signal.signal(signal.SIGINT, _handler)
    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGHUP, signal.SIG_IGN)
    if dump_cb is not None:
        def _dump(_signum, _frame):
            try:
                log.info("runtime introspection: %s", dump_cb())
            except Exception:  # never let a diagnostics hook kill us
                log.exception("runtime dump failed")

        signal.signal(signal.SIGUSR1, _dump)
