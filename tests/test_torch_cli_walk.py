"""The port CLI's file walk (-r/-R) and its filters (--include, --exclude,
--exclude-dir), against the reference CLI in process (byte-identical
stdout, the same exit code) and against GNU grep (the searched files and
lines)."""

import os
import shutil
import subprocess

import pytest

from distributed_grep_tpu_torch.cli_inputs import dir_excluded, included
from tests.test_torch_cli_display import assert_same, run_both


@pytest.fixture
def tree(tmp_path):
    """Nested dirs, a symlinked dir and file, a symlink cycle and files of
    three extensions (the -R error test adds a dangling symlink)."""
    root = tmp_path / "tree"
    files = {
        "a.txt": "volcano one\nplain\n",
        "b.log": "volcano in a log\n",
        "c.md": "nothing here\n",
        "sub/c.txt": "the volcano\nvolcano again\n",
        "sub/deep/d.txt": "deep volcano\n",
        "sub/deep/e.log": "x\nvolcano e\n",
        "build/f.txt": "volcano built\n",
        "build/sub/g.txt": "volcano g\n",
        ".hidden/h.txt": "volcano hidden\n",
        "other/i.txt": "volcano i\nno\nvolcano i2\n",
    }
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    (root / "link_dir").symlink_to(root / "sub")
    (root / "link_file.txt").symlink_to(root / "a.txt")
    (root / "cycle").mkdir()
    (root / "cycle" / "loop").symlink_to(root)
    return root


WALK_FLAGS = [
    ["-r"], ["-R"], ["-r", "-c"], ["-R", "-l"], ["-r", "-L"], ["-r", "-o"],
    ["-r", "-h"], ["-r", "-m", "1"], ["-r", "-C", "1"], ["-r", "-b"],
    ["-r", "--include", "*.txt"], ["-r", "--exclude", "*.txt"],
    ["-r", "--include", "*.txt", "--exclude", "a*"],
    ["-r", "--exclude", "a*", "--include", "*.txt"],
    ["-r", "--include", "*.log", "--include", "*.md"],
    ["-r", "--exclude-dir", "build"], ["-r", "--exclude-dir", "sub"],
    ["-r", "--exclude-dir", "tree/build"], ["-r", "--exclude-dir", "*/sub"],
    ["-r", "--exclude-dir", ".*"], ["-R", "--exclude-dir", "sub"],
    ["-r", "--exclude-dir", "tree"], ["-r", "--include", "*.none"],
    ["-R", "--include", "*.txt", "-c"], ["-r", "-v", "-c"],
]


@pytest.mark.parametrize("flags", WALK_FLAGS, ids=" ".join)
def test_walk_identical_to_reference_cli(tree, capsysbinary, monkeypatch,
                                         flags):
    assert_same(capsysbinary, monkeypatch, [*flags, "volcano", str(tree)])


@pytest.mark.parametrize("flags", [["-R"], ["-R", "-s"], ["-R", "-c"],
                                   ["-R", "-q"]], ids=" ".join)
def test_dangling_symlink_under_R_is_an_error(tree, capsysbinary,
                                              monkeypatch, flags):
    """A dangling symlink met under -R cannot be opened (also as root):
    GNU grep reports it and exits 2; plain -r skips it."""
    (tree / "dangling.txt").symlink_to(tree / "missing")
    (prc, _out, perr), (rrc, _) = run_both(capsysbinary, monkeypatch,
                                           [*flags, "volcano", str(tree)])
    assert prc == rrc == (0 if "-q" in flags else 2)
    assert (b"dangling.txt" in perr) == ("-s" not in flags)
    assert_same(capsysbinary, monkeypatch, [*flags, "volcano", str(tree)])
    assert_same(capsysbinary, monkeypatch, ["-r", "volcano", str(tree)])


@pytest.mark.parametrize("flags", [
    ["--include", "*.log"], ["--exclude", "*.txt"], ["--exclude", "*.log"],
    ["--include", "*.txt", "--exclude", "a.*"], ["--exclude", "*", "-c"],
    ["--include", "a.txt", "-l"]], ids=" ".join)
def test_include_exclude_apply_to_named_files(tree, capsysbinary,
                                              monkeypatch, flags):
    assert_same(capsysbinary, monkeypatch,
                [*flags, "volcano", str(tree / "a.txt"), str(tree / "b.log")])


@pytest.mark.parametrize("flags", [["-r"], ["-R", "-c"], ["-r", "-l"],
                                   ["-r", "--include", "*.log"]],
                         ids=" ".join)
def test_recursive_without_file_searches_the_cwd(tree, capsysbinary,
                                                 monkeypatch, flags):
    monkeypatch.chdir(tree)
    out = assert_same(capsysbinary, monkeypatch, [*flags, "volcano"])
    assert out


def test_named_directory_without_r_and_dirs_mixed(tree, capsysbinary,
                                                  monkeypatch):
    (prc, pout, perr), (rrc, rout) = run_both(
        capsysbinary, monkeypatch, ["volcano", str(tree)])
    assert prc == rrc == 2 and pout == rout == b""
    assert b"is a directory" in perr
    assert_same(capsysbinary, monkeypatch,
                ["-r", "volcano", str(tree / "sub"), str(tree / "a.txt"),
                 str(tree / "missing.txt")])
    assert_same(capsysbinary, monkeypatch,
                ["-r", "volcano", str(tree / "link_dir")])


@pytest.mark.parametrize("name,filters,want", [
    ("a.txt", [], True),
    ("a.txt", [("include", "*.txt")], True),
    ("a.log", [("include", "*.txt")], False),
    ("a.log", [("exclude", "*.txt")], True),
    ("a.txt", [("include", "*.txt"), ("exclude", "a*")], False),
    ("a.txt", [("exclude", "a*"), ("include", "*.txt")], True),
    ("b.md", [("exclude", "a*"), ("include", "*.txt")], True),
    ("b.md", [("include", "*.txt"), ("exclude", "a*")], False),
])
def test_glob_filter_order(name, filters, want):
    assert included(name, filters) is want


def test_exclude_dir_matches_basenames_only():
    assert dir_excluded("build", ["build"])
    assert dir_excluded("build", ["b*"])
    assert not dir_excluded("build", ["tree/build"])
    assert not dir_excluded("sub", ["*/sub"])


@pytest.mark.skipif(shutil.which("grep") is None, reason="no GNU grep")
@pytest.mark.parametrize("flags", [["-r"], ["-r", "--include", "*.txt"],
                                   ["-r", "--exclude-dir", "build"],
                                   ["-r", "--exclude", "*.log", "-c"]],
                         ids=" ".join)
def test_walk_equals_gnu_grep(tree, capsysbinary, flags):
    """(path, line) pairs -- or per-file counts -- of the port's -r equal
    GNU grep's over the same tree (GNU prints traversal paths, the port
    resolved ones; plain -r skips the symlinks, so they agree)."""
    from distributed_grep_tpu_torch.__main__ import main as port_main

    rc = port_main(["grep", *flags, "volcano", str(tree), "--device", "cpu"])
    out = capsysbinary.readouterr().out.decode()
    gnu = subprocess.run(["grep", "-n", *flags, "volcano", str(tree)],
                         capture_output=True, text=True,
                         env={**os.environ, "LC_ALL": "C"})
    assert rc == gnu.returncode
    if "-c" in flags:
        assert sorted(out.splitlines()) == sorted(gnu.stdout.splitlines())
        return
    got = sorted((ln.split(" (line number #")[0],
                  int(ln.split(" (line number #")[1].split(")")[0]))
                 for ln in out.splitlines())
    want = sorted((os.path.realpath(ln.split(":")[0]), int(ln.split(":")[1]))
                  for ln in gnu.stdout.splitlines())
    assert got == want and got
