"""The port's task store (testground_tpu_torch/task/) against the JAX
package's: a file store written by the port has the JAX store's layout
(its SQLite schema) and rows (each task's JSON, byte for byte), each
package's store reads the other's tasks field for field, and the two
queues agree on the same operations: priority order, branch dedup,
cancel, the boot-time reload that requeues an interrupted run with a
resume request, backoff, and the failed-runs listing."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import sqlite3
import time

import pytest

from testground_tpu import task as jtask
from testground_tpu_torch import task as ttask

PKGS = {"jax": jtask, "port": ttask}


def tasks(pkg):
    T = PKGS[pkg]
    done = T.Task(id="b1", type=T.TYPE_RUN, plan="p", case="c",
                  created=100.0, created_by={"repo": "o/r"},
                  composition={"global": {"plan": "p"}},
                  input={"sources_dir": None, "affinity": "a" * 32})
    done.states.append(T.task.StateTransition(T.STATE_PROCESSING, 101.0))
    done.states.append(T.task.StateTransition(T.STATE_COMPLETE, 102.0))
    done.result = {"run_id": "b1", "outcome": "preempted", "outcomes": {},
                   "journal": {"ticks": 75}}
    busy = T.Task(id="b2", type=T.TYPE_RUN, plan="p", case="c",
                  created=103.0, priority=5, progress={"tick": 25})
    busy.states.append(T.task.StateTransition(T.STATE_PROCESSING, 104.0))
    build = T.Task(id="b3", type=T.TYPE_BUILD, created=105.0,
                   error="BuildError: no sim.py")
    build.states.append(T.task.StateTransition(T.STATE_COMPLETE, 106.0))
    return [done, busy, build]


def rows(path):
    con = sqlite3.connect(path)
    try:
        schema = sorted(r[0] for r in con.execute(
            "SELECT sql FROM sqlite_master WHERE sql IS NOT NULL"))
        data = con.execute(
            "SELECT id, state, created, priority, data FROM tasks "
            "ORDER BY id").fetchall()
    finally:
        con.close()
    return schema, data


def test_the_port_writes_the_jax_store_layout_and_json(tmp_path):
    for pkg in PKGS:
        st = PKGS[pkg].TaskStorage(tmp_path / f"{pkg}.db")
        for t in tasks(pkg):
            st.put(t)
        st.close()
    assert rows(tmp_path / "port.db") == rows(tmp_path / "jax.db")


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_each_store_reads_the_others(writer, reader, tmp_path):
    path = tmp_path / "tasks.db"
    st = PKGS[writer].TaskStorage(path)
    for t in tasks(writer):
        st.put(t)
    st.close()
    other = PKGS[reader].TaskStorage(path)
    want = [t.to_dict() for t in tasks(reader)]
    assert [t.to_dict() for t in other.all()] == want
    assert other.get("b2").progress == {"tick": 25}
    assert [t.id for t in other.by_state("complete")] == ["b3", "b1"]
    assert [t.id for t in other.failed_runs()] == ["b1"]
    assert [t.id for t in other.pending()] == ["b2"]
    # the boot-time reload: the interrupted run is scheduled again,
    # with a resume request, and the store records it
    q = PKGS[reader].TaskQueue(other)
    t = q.pop(timeout=0)
    assert t.id == "b2" and t.state == "scheduled"
    assert t.input == {"resume": True}
    assert other.get("b2").to_dict() == t.to_dict()
    q.close()
    other.close()


def _queue_ops(pkg):
    """A queue's answers to one sequence of operations."""
    T = PKGS[pkg]
    st = T.MemoryTaskStorage()
    q = T.TaskQueue(st)
    out = []
    mk = lambda i, **kw: T.Task(id=i, type=T.TYPE_RUN, created=float(  # noqa
        len(i)), **kw)
    q.push(mk("a", priority=0))
    q.push(mk("bb", priority=3))
    q.push(mk("ccc", priority=3))
    by = {"repo": "o/r", "branch": "main"}
    q.push(mk("dddd", priority=1, created_by=dict(by)))
    out.append(q.push_unique_by_branch(mk("eeeee", priority=1,
                                          created_by=dict(by))))
    out.append(q.cancel("a"))
    out.append(q.cancel("nosuch"))
    out.append(len(q))
    late = mk("ffffff", priority=9, backoff_until=time.time() + 0.2)
    q.push(late)
    out.append([q.pop(timeout=1).id for _ in range(3)])
    out.append(q.depth_and_oldest_age()[0])
    out.append(q.pop(timeout=1).id)
    out.append(q.pop(timeout=0.01))
    out.append([(t.id, t.state) for t in st.all()])
    q.close()
    return out


def test_the_queues_agree():
    assert _queue_ops("port") == _queue_ops("jax")
