"""The kernel build under threads: a stand-in ``nvcc`` first on PATH
counts its runs, and four threads that build and load at once must start
one compiler a source and all get the final library."""

import os
import stat
import threading

import pytest

from nezha_tpu_torch.ops.cuda import build

FAKE_NVCC = """#!/bin/sh
# Record the source, linger so racing callers overlap, write -o's file.
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
src="$a"
echo "$src" >> "$NVCC_LOG"
sleep 0.3
echo built > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("NVCC_LOG", str(log))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    # load() would dlopen the stand-in's output: hand back its path.
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    build._load.cache_clear()
    yield log
    build._load.cache_clear()


def test_nvcc_path_finds_the_stand_in_first(fake_nvcc):
    assert build.nvcc_path().endswith(os.path.join("bin", "nvcc"))
    assert os.path.dirname(build.nvcc_path()) == os.environ["PATH"].split(
        os.pathsep)[0]


@pytest.mark.parametrize("entry", ["build_all", "load"])
def test_four_threads_run_one_compiler_per_source(fake_nvcc, entry):
    names = ("paged_decode", "paged_prefill")
    barrier = threading.Barrier(4)
    got, errors = [], []

    def worker():
        try:
            barrier.wait()
            if entry == "build_all":
                build.build_all(names)
                got.append([str(build.library_path(n)) for n in names])
            else:
                got.append([build.load(n) for n in names])
        except BaseException as e:   # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    runs = fake_nvcc.read_text().split()
    assert sorted(os.path.basename(r) for r in runs) == sorted(
        f"{n}.cu" for n in names)
    final = [str(build.library_path(n)) for n in names]
    assert got == [final] * 4
    for path in final:
        assert open(path).read().strip() == "built"
    # No temporary file is left beside the libraries.
    for n in names:
        leftovers = [p.name for p in build.library_path(n).parent.iterdir()
                     if p.suffix == ".tmp"]
        assert leftovers == []


def test_temporary_output_is_named_by_process_and_thread(fake_nvcc,
                                                          monkeypatch):
    seen = []
    real_popen = build.subprocess.Popen

    def spy(cmd, **kw):
        seen.append(cmd[cmd.index("-o") + 1])
        return real_popen(cmd, **kw)

    monkeypatch.setattr(build.subprocess, "Popen", spy)
    build.build_all(("flash_decode",))
    assert seen and seen[0].endswith(
        f".{os.getpid()}.{threading.get_ident()}.tmp")
