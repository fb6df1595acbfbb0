"""The port's Data library (``ray_tpu_torch.data``) against the JAX
package's (``ray_tpu.data``).

One table of small Data programs (tests/torch_data_programs.py) runs
once on ``ray_tpu`` and once on ``ray_tpu_torch``, each runtime started
once for the table (the JAX package's first and shut down before the
port's starts). Results must be equal: every array's dtype, shape and
values, every row's columns in order. The programs of ``CLOSE`` hold
random float columns whose group sums, means and stds depend on the
summation order (pyarrow's against numpy's): their floats within
``CLOSE_RTOL``, the rest exactly.

Then the port alone: its pyarrow-free programs again in a process where
``pyarrow`` and ``pandas`` cannot be imported (a meta-path blocker in
the driver, packages that raise on import ahead of them on the workers'
path), with the same results; ``read_parquet`` there raises ImportError
naming pyarrow; ``import ray_tpu_torch.data`` loads no torch, pyarrow or
pandas, and a block task's worker has none of them and sees no card.
And the TFRecord readers: the native scanner (``native/tfrec.cpp``) and
the pure-Python codec read the same records as the JAX package's reader,
and raise the same ValueError on a truncated frame and on a CRC mismatch
under ``verify=True``.
"""

from __future__ import annotations

import importlib
import math
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_data_programs as programs
import torch_runtime_programs

PACKAGES = ("ray_tpu", "ray_tpu_torch")
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_worker_left():
    """Torn down after the module's runtimes: none leaves a worker
    process behind for the tests that follow."""
    yield
    assert torch_runtime_programs.workers_left() == []


def _run_table(name: str) -> dict:
    rt = importlib.import_module(name)
    rt.init(num_cpus=4)
    try:
        return {prog: programs.run(fn, rt)
                for prog, fn in programs.TABLE.items()}
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def table() -> dict:
    """{package: {program: outcome}}, the JAX package's run first."""
    t0 = time.perf_counter()
    out = {name: _run_table(name) for name in PACKAGES}
    print(f"Data table on both packages: {time.perf_counter() - t0:.1f} s")
    return out


def _close(a, b, rtol: float) -> bool:
    """``a == b`` with floats within ``rtol`` of each other."""
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=rtol)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_close(x, y, rtol) for x, y in zip(a, b)))
    return a == b


@pytest.mark.parametrize("program", list(programs.TABLE))
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    if program in programs.CLOSE:
        assert _close(port_out, jax_out, programs.CLOSE_RTOL), \
            (port_out, jax_out)
    else:
        assert port_out == jax_out


def _values(outcome, column: str) -> list:
    """One column's values over the rows of a canonical take_all()."""
    return [dict(row[1])[column] for row in outcome]


def test_table_outcomes_are_the_expected_ones(table):
    """The parity above would also pass if both packages were wrong in
    the same way: the results that pyarrow fixes, against numpy."""
    out = {k: v[1] for k, v in table["ray_tpu_torch"].items()}
    keys = [3, 1, 2, 3, 1, 2, 3, 0, 1, 2, 3, 0]
    pos = [p for _, p in sorted(zip(keys, range(12)), key=lambda x: x[0])]
    assert [p[2] for p in _values(out["sort_ascending_ties"], "pos")] == \
        pos
    desc = [p for _, p in sorted(zip(keys, range(12)), key=lambda x: -x[0])]
    assert [p[2] for p in _values(out["sort_descending_ties"][0],
                                  "pos")] == desc      # ties stay in order
    sums, means, stds = out["groupby_aggregates"][:3]
    assert [v[2] for v in _values(sums, "sum(v)")] == [16, 60, 7]
    assert [v[2] for v in _values(means, "mean(v)")] == [4.0, 20.0, 7.0]
    assert [v[2] for v in _values(stds, "std(v)")] == [
        float(np.std([1, 3, 5, 7], ddof=1)), 10.0, "nan"]
    assert [v[1] for v in _values(sums, "sum(v)")] == ["<i8"] * 3
    count = out["groupby_aggregates"][-1]
    assert [dict(r[1]) for r in count] == [
        {"g": g, "count()": ("scalar", "<i8", n)}
        for g, n in (("a", 4), ("b", 3), ("c", 1))]
    zipped = out["zip_and_union"][0]
    assert [k for k, _ in zipped[0][1]] == ["id", "id_1", "other"]
    shards = out["streaming_split_two"]
    assert [[b[3] for b in s] for s in shards] == [
        [[0, 1], [4, 5], [8, 9]], [[2, 3], [6, 7]]]   # block i -> i % 2
    assert out["all_filtered_schema"] == [0, ["x", "y"], ["x", "y"], []]


# -- the port without pyarrow and pandas ---------------------------------------

_BLOCKED_CHILD = r"""
import importlib, importlib.abc, os, pickle, sys
BLOCKED = ("pyarrow", "pandas")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this process")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, os.environ["SHADOW_DIR"])   # the workers' blocker
sys.path.insert(0, os.environ["TESTS_DIR"])

import ray_tpu_torch.data
out = {"loaded_by_import": sorted(
    {m.split(".")[0] for m in sys.modules} &
    {"torch", "pyarrow", "pandas", "jax", "ray_tpu"})}
import ray_tpu_torch as rt
import torch_data_programs as programs
rt.init(num_cpus=4)
try:
    probe = rt.data.range(4, parallelism=2).map_batches(
        programs.block_worker_view)
    out["worker"] = probe.take_all()
    def try_pyarrow(batch):
        import numpy as np
        try:
            import pyarrow  # noqa: F401
            got = "imported"
        except ImportError as e:
            got = str(e)
        return {"pyarrow": np.asarray([got] * len(batch["id"]))}
    out["worker_pyarrow"] = rt.data.range(1).map_batches(
        try_pyarrow).take_all()[0]["pyarrow"]
    try:
        rt.data.read_parquet(os.environ["TESTS_DIR"])
        out["read_parquet"] = None
    except ImportError as e:
        out["read_parquet"] = str(e)
    out["programs"] = {name: programs.run(programs.TABLE[name], rt)
                       for name in programs.PYARROW_FREE}
finally:
    rt.shutdown()
with open(os.environ["OUT_FILE"], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def blocked(tmp_path_factory, table) -> dict:
    """The port's run of the pyarrow-free programs in a process where
    pyarrow and pandas cannot be imported, after the table."""
    tmp = tmp_path_factory.mktemp("no_pyarrow")
    shadow = tmp / "shadow"
    for pkg in ("pyarrow", "pandas"):
        (shadow / pkg).mkdir(parents=True)
        (shadow / pkg / "__init__.py").write_text(
            f"raise ImportError('{pkg} is blocked in this process')\n")
    env = dict(os.environ, SHADOW_DIR=str(shadow),
               TESTS_DIR=str(ROOT / "tests"), OUT_FILE=str(tmp / "out.pkl"),
               PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_CHILD],
                          cwd=tmp, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("program", programs.PYARROW_FREE)
def test_port_gives_the_same_result_without_pyarrow_and_pandas(
        blocked, table, program):
    assert blocked["programs"][program] == table["ray_tpu_torch"][program]


def test_read_parquet_without_pyarrow_names_it(blocked):
    assert "pyarrow" in blocked["worker_pyarrow"]     # blocked there too
    msg = blocked["read_parquet"]
    assert msg is not None and "read_parquet needs pyarrow" in msg, msg


def test_import_and_block_tasks_load_no_torch(blocked):
    assert blocked["loaded_by_import"] == []
    for row in blocked["worker"]:
        assert row["loaded"] == "", row
        assert row["cuda"] == "", row


# -- TFRecord readers ----------------------------------------------------------


def _records(n: int = 40) -> list[bytes]:
    rng = np.random.default_rng(5)
    return [rng.bytes(int(k)) for k in rng.integers(0, 3000, n)]


def _read_all(codec, path, native: bool, monkeypatch, verify=True):
    from ray_tpu_torch.native import tfrec
    if native:
        assert tfrec.get_lib() is not None, "the native scanner did not build"
    else:
        monkeypatch.setattr(tfrec, "get_lib", lambda: None)
    try:
        return list(codec.read_records(str(path), verify=verify))
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_tfrecord_readers_agree(tmp_path, monkeypatch, native):
    from ray_tpu.data import tfrecord as jax_codec
    from ray_tpu_torch.data import tfrecord as codec
    recs = _records()
    path = tmp_path / "r.tfrecord"
    jax_codec.write_records(str(path), recs)
    assert _read_all(codec, path, native, monkeypatch) == recs
    assert list(jax_codec.read_records(str(path), verify=True)) == recs
    mine = tmp_path / "mine.tfrecord"
    codec.write_records(str(mine), recs)
    assert mine.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_tfrecord_readers_refuse_a_truncated_frame_and_a_bad_crc(
        tmp_path, monkeypatch, native):
    from ray_tpu_torch.data import tfrecord as codec
    recs = _records(6) + [b"x" * 100]
    good = tmp_path / "good.tfrecord"
    codec.write_records(str(good), recs)
    raw = good.read_bytes()
    cut = tmp_path / "cut.tfrecord"
    cut.write_bytes(raw[:-3])
    with pytest.raises(ValueError, match=r"cut\.tfrecord: .*truncated"):
        _read_all(codec, cut, native, monkeypatch)
    bad = bytearray(raw)
    bad[-6] ^= 0x40                       # a payload byte of the last one
    flipped = tmp_path / "flipped.tfrecord"
    flipped.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match=r"flipped\.tfrecord: .*crc mismatch"):
        _read_all(codec, flipped, native, monkeypatch)
    # Without verify the flipped payload is read as it is.
    got = _read_all(codec, flipped, native, monkeypatch, verify=False)
    assert got[:-1] == recs[:-1] and got[-1] != recs[-1]
