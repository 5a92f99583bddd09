"""Device policy, paramfile loader, compile cache and the GPU smoke script.

CPU tests of what decides where and how the program runs: the YAML-subset
paramfile loader (no PyYAML needed), the compile-cache location, the
compute-device choice (no silent CPU fallback), ``bench.py``'s platform
probe and refusal to time a CPU by default, and ``chip_smoke.py``'s device
check, result line and phases at tiny sizes on the CPU.  The ``gpu``-marked
tests repeat the card-only checks and skip without a GPU.
"""

import json
import os
import shutil
import signal
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ------------------------------------------------------------ paramfile


@pytest.mark.parametrize("text, expected", [
    ("1.", 1.0),
    ("1.e-8", 1e-8),
    ("1e-8", "1e-8"),             # YAML 1.1: no dot, no float
    ("5,3,1", "5,3,1"),
    ("200,2", "200,2"),
    ("2", 2),
    ("-3", -3),
    ("null", None),
    ("", None),
    ("True", True),
    ("False", False),
    ("'quoted # not a comment'", "quoted # not a comment"),
    ("-2*sin(pi*x)**2*sin(pi*y)*cos(pi*y)",
     "-2*sin(pi*x)**2*sin(pi*y)*cos(pi*y)"),
])
def test_paramfile_scalars(text, expected):
    from dgtpu.settings import parse_params
    got = parse_params(f"key: {text}   # trailing comment\n")["key"]
    assert got == expected and type(got) is type(expected)


@pytest.mark.parametrize("text, expected", [
    ("a:\n  b: 1\n  c:\n    d: x\ne: 2\n",
     {"a": {"b": 1, "c": {"d": "x"}}, "e": 2}),
    ("# header\nkey with spaces: v\n\n  # indented comment\nempty:\nz: 1.\n",
     {"key with spaces": "v", "empty": None, "z": 1.0}),
    ("a:\n  b:\n    c: 1\n  d: 2\ne:\n  f: 3\n",
     {"a": {"b": {"c": 1}, "d": 2}, "e": {"f": 3}}),
])
def test_paramfile_nesting(text, expected):
    from dgtpu.settings import parse_params
    assert parse_params(text) == expected


@pytest.mark.parametrize("text", [
    "a:\n\tb: 1\n",           # tab indentation
    "a: 1\na: 2\n",           # duplicate key
    "just words\n",           # no key
])
def test_paramfile_rejects_malformed(text):
    from dgtpu.settings import parse_params
    with pytest.raises(ValueError):
        parse_params(text)


def test_paramfile_matches_yaml_safe_load():
    yaml = pytest.importorskip("yaml")
    from dgtpu.settings import DEFAULT_PARAMFILE, load_params
    with open(DEFAULT_PARAMFILE) as f:
        assert load_params() == yaml.safe_load(f)


# -------------------------------------------------------- device policy


def test_default_matmul_precision_is_highest():
    import jax
    import dgtpu  # noqa: F401
    assert jax.config.jax_default_matmul_precision == "highest"


@pytest.mark.parametrize("name, platform", [
    ("auto", "cpu"), ("cpu", "cpu"), ("gpu", None)])
def test_default_compute_device(base_settings, name, platform):
    from dgtpu.utils.device import default_compute_device
    base_settings.update_setting("performance.device", name)
    if platform is None:
        with pytest.raises(RuntimeError, match="no 'gpu' device"):
            default_compute_device(base_settings)
    else:
        assert default_compute_device(base_settings).platform == platform


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_location(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR is used as it is when set; otherwise the
    cache lives at a fixed path in the checkout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax; from dgtpu.utils.device import enable_compile_cache;"
            "p = enable_compile_cache(); "
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()[-2:]
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(REPO, ".jax_cache"))
    assert returned == configured == want


# ------------------------------------------------------------ bench.py


@pytest.fixture()
def restore_signals():
    yield
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.default_int_handler)


def test_bench_probe_reports_device():
    out = subprocess.run(
        [sys.executable, "bench.py", "--stage", "probe", "--backend", "cpu",
         "--budget-s", "60"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["platform"] == "cpu" and last["device_kind"] == "cpu"
    assert last["device_count"] >= 1 and "card" in last


def test_bench_refuses_cpu_without_backend(capsys, monkeypatch,
                                           restore_signals):
    import bench
    # the probe child inherits this environment: keep it off any card
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    rc = bench.main(["--budget-s", "300", "--skip-configs",
                     "--skip-scaling"])
    assert rc != 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    last = json.loads(lines[-1])
    assert last["platform"] == "cpu" and "expected 'gpu'" in last["error"]
    assert last["value"] is None          # nothing was timed


def test_bench_failures_flag_errors():
    import bench
    result = {"stage_walls": {"flagship": {"rc": 0, "timed_out": False},
                              "stokes": {"rc": 1, "timed_out": False}},
              "configs": [{"config": "ok"}, {"config": "x", "error": "E"}]}
    assert bench.failures(result) == ["stage stokes", "config x"]
    assert bench.failures({}) == []


# -------------------------------------------------------- chip_smoke.py


class _Dev:
    def __init__(self, platform, kind):
        self.platform, self.device_kind = platform, kind


def test_chip_smoke_last_line():
    import chip_smoke
    devs = [_Dev("gpu", "NVIDIA H100 80GB HBM3")] * 4
    assert chip_smoke.last_line(devs[:1]) == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(chip_smoke.last_line(devs))["device"]["count"] == 4


def test_chip_smoke_requires_gpu():
    import jax
    import chip_smoke
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(jax.devices())
    assert e.value.code != 0
    dev = _Dev("gpu", "x")
    assert chip_smoke.require_gpu([dev]) is dev


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_script_fails_without_gpu(tmp_path, alone):
    """No GPU, or no repo beside the script: non-zero exit, no result."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_cfs_keep_a_row_per_card():
    import chip_smoke
    assert chip_smoke._cfs_for_rows(64, 4) == "2,4,8,16"
    assert chip_smoke._cfs_for_rows(16, 4) == "2,4"
    assert chip_smoke._cfs_for_rows(8, 1) == "2,4"


@pytest.fixture()
def tiny_paramfile(tmp_path):
    """The paramfile with a 4x4 p=2 grid and export off."""
    with open(os.path.join(REPO, "input", "paramfile.yml")) as f:
        src = f.read()
    for a, b in (("filename: Rectangle_8X8_nPoly5.xyz",
                  "filename: Rectangle_4X4_nPoly2.xyz"),
                 ("  polynomial degree: 5\n  O grid",
                  "  polynomial degree: 2\n  O grid"),
                 ("    polynomial degree: 5\n    integration",
                  "    polynomial degree: 2\n    integration"),
                 ("u: 5,3,1", "u: 1,2"), ("  export: True", "  export: False")):
        assert a in src
        src = src.replace(a, b)
    path = tmp_path / "paramfile.yml"
    path.write_text(src)
    return str(path)


def test_chip_smoke_cli_phase_on_cpu(tiny_paramfile, capsys):
    import chip_smoke
    dg = chip_smoke.phase_cli(paramfile=tiny_paramfile)
    assert dg.residuals[-1] <= 1e-6 and dg.levels[-1].Ni == 4
    assert "cli: python -m dgtpu -m --silent" in capsys.readouterr().out


def test_chip_smoke_config_phase_on_cpu(capsys):
    import chip_smoke
    chip_smoke.phase_configs(names={"1_direct_4x4_p1", "5a_stokes_dgs_4x4"})
    out = capsys.readouterr().out
    assert "1_direct_4x4_p1" in out and "5a_stokes_dgs_4x4" in out


def test_chip_smoke_mixed_phase_on_cpu(capsys):
    import chip_smoke
    chip_smoke.phase_mixed(n=4, p=2, check_n=4, check_p=2,
                           tf32_must_fail=False)
    out = capsys.readouterr().out
    assert "rolled f32 cycle 4x4 p=2" in out
    assert "iterate after 2 cycles vs CPU (max rel): cpu 0.00e+00" in out


@pytest.mark.parametrize("gap, ok", [
    (0.0, True), (9.9e-5, True), (1e-4, True), (1.1e-4, False), (3e-3, False)])
def test_chip_smoke_precision_limit(gap, ok):
    import chip_smoke
    if ok:
        chip_smoke.precision_ok(gap, 1e-4, "gpu")
    else:
        with pytest.raises(AssertionError, match="TF32"):
            chip_smoke.precision_ok(gap, 1e-4, "gpu")


def test_chip_smoke_precision_check_must_catch_tf32():
    """Where TF32 products do not move the iterate (the CPU ignores the
    TF32 setting), the check cannot catch TF32 and says so."""
    import __graft_entry__
    import chip_smoke
    dg = __graft_entry__._flagship(n=4, p_grid=2, p_sol=2)
    with pytest.raises(AssertionError, match="cannot catch TF32"):
        chip_smoke.precision_gap(dg, cycles=2)


def test_chip_smoke_four_card_phase_on_virtual_devices(capsys):
    """The sharded phase on four of the suite's virtual CPU devices."""
    import chip_smoke
    chip_smoke.phase_four_cards(n_cards=4, n=8, p=1, stokes_n=8)
    out = capsys.readouterr().out
    assert out.count("four_cards:") == 3


# ------------------------------------------------------------- on a GPU


@pytest.mark.gpu
def test_gpu_f32_cycle_matches_cpu(gpu_device):
    """The f32 rolled cycle's iterate on the card is the CPU's (no TF32),
    and the same cycle with TF32 products fails that check."""
    import __graft_entry__
    import chip_smoke
    chip_smoke.precision_gap(__graft_entry__._flagship(n=8, p_grid=5,
                                                       p_sol=5))
