"""The port's northbound transaction engine (``holo_tpu_torch.northbound``)
against ``holo_tpu.northbound`` on the CPU.

Each case runs one provider script through both packages' ``Northbound``
(over each package's ``full_schema``) with a recording provider, and
compares what each provider saw (the phases and changed paths of every
fan-out) and the transaction log (ids, comments, changes, configurations;
not the wall-clock timestamps of the commits that take none):

- commits of two configurations;
- a validate refusal and a Prepare refusal (with the Abort fan-out), the
  running configuration kept;
- a rollback to the first transaction;
- a confirmed commit: kept before its timeout, rolled back after it;
- the database: a ``Northbound`` over the ``[database]`` file another one
  wrote (either package's) restores its transaction log, and a rollback to
  the last transaction restores its configuration.

Tolerance: exact.
"""

from __future__ import annotations

import pytest

from holo_tpu.northbound import core as jcore
from holo_tpu.northbound import provider as jprov
from holo_tpu.yang import modules as jmodules
from holo_tpu_torch.northbound import core as tcore
from holo_tpu_torch.northbound import provider as tprov
from holo_tpu_torch.yang import modules as tmodules

PKGS = {"jax": (jcore, jprov, jmodules), "port": (tcore, tprov, tmodules)}


def _recorder(prov):
    class Recorder(prov.Provider):
        """Vetoes hostname "veto" in validate and contact "refuse" in
        Prepare; records every fan-out it sees."""

        name = "recorder"
        subtree_prefixes = ("system", "interfaces")

        def __init__(self):
            self.seen = []

        def validate(self, new_tree):
            if new_tree.get("system/hostname") == "veto":
                raise prov.CommitError("hostname veto")

        def commit(self, phase, old, new, changes):
            self.seen.append((phase.value, sorted(c.path for c in changes)))
            if phase == prov.CommitPhase.PREPARE and new.get("system/contact") == "refuse":
                raise prov.CommitError("contact refused")

    return Recorder()


def _engine(pkg: str, db_path=None):
    core, prov, modules = PKGS[pkg]
    rec = _recorder(prov)
    return core.Northbound(modules.full_schema(), [rec], db_path=db_path), rec, prov


def _config(nb, hostname: str, addr: str, contact: str | None = None):
    c = nb.running.copy()
    c.set("system/hostname", hostname)
    c.set("interfaces/interface[eth0]/address", [addr])
    if contact is not None:
        c.set("system/contact", contact)
    return c


def _log(nb, timestamps: bool = True) -> list:
    return [(t.id, t.timestamp if timestamps else None, t.comment, t.changes_json,
             t.config_json) for t in nb.txn_log]


def _run(pkg: str, script) -> tuple:
    nb, rec, prov = _engine(pkg)
    out = script(nb, prov)
    return out, rec.seen, nb.running.to_json()


def _commits(nb, prov):
    nb.commit(_config(nb, "r1", "10.0.0.1/24"), comment="first", now=1.0)
    nb.commit(_config(nb, "r2", "10.0.1.1/24"), comment="second", now=2.0)
    nb.commit(nb.running.copy(), comment="no change", now=3.0)
    return _log(nb)


def _refusals(nb, prov):
    nb.commit(_config(nb, "r1", "10.0.0.1/24"), now=1.0)
    errors = []
    for cand in (_config(nb, "veto", "10.0.0.2/24"),
                 _config(nb, "r1", "10.0.0.3/24", contact="refuse")):
        with pytest.raises(prov.CommitError) as e:
            nb.commit(cand, now=2.0)
        errors.append(str(e.value))
    return errors, _log(nb)


def _rollback(nb, prov):
    nb.commit(_config(nb, "r1", "10.0.0.1/24"), now=1.0)
    nb.commit(_config(nb, "r2", "10.0.1.1/24"), now=2.0)
    txn = nb.rollback(1)
    with pytest.raises(KeyError):
        nb.rollback(99)
    return txn.id, txn.comment, nb.running.to_json() == nb.txn_log[0].config_json, _log(
        nb, timestamps=False)


def _confirmed(nb, prov):
    nb.commit(_config(nb, "r1", "10.0.0.1/24"), now=1.0)
    nb.commit(_config(nb, "r2", "10.0.1.1/24"), confirmed_timeout=10.0, now=100.0)
    early = nb.check_confirmed_timeout(105.0)
    running = nb.running.get("system/hostname")
    late = nb.check_confirmed_timeout(111.0)
    again = nb.check_confirmed_timeout(200.0)
    return early, running, late, again, nb.running.get("system/hostname"), _log(nb)


@pytest.mark.parametrize("script", [_commits, _refusals, _rollback, _confirmed],
                         ids=["commit", "refusals", "rollback", "confirmed-commit"])
def test_script_is_equal_to_holo_tpus(script):
    got = _run("port", script)
    want = _run("jax", script)
    assert got == want
    assert got[1]  # the provider saw fan-outs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_database_restores_the_log_and_the_configuration(tmp_path, writer):
    db = tmp_path / "holo.db"
    nb, _, _ = _engine(writer, db)
    nb.commit(_config(nb, "r1", "10.0.0.1/24"), comment="first", now=1.0)
    nb.commit(_config(nb, "r2", "10.0.1.1/24"), comment="second", now=2.0)
    wrote, text = _log(nb), db.read_text()
    restored = {}
    for pkg in PKGS:
        db.write_text(text)  # each package boots from the file as written
        boot, rec, _ = _engine(pkg, db)
        assert _log(boot) == wrote
        assert boot.running.to_json() == _engine(pkg)[0].running.to_json()  # log only
        boot.rollback(boot.txn_log[-1].id)
        restored[pkg] = (boot.running.to_json(), rec.seen, _log(boot, timestamps=False))
    assert restored["port"] == restored["jax"]
    assert restored["port"][0] == wrote[-1][4]
