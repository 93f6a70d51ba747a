"""chip_smoke.py (the port's check on the card) fails when any phase
fails: its `main` catches exceptions in one place only, the final handler
that names the phase and returns 1, so no measurement or check can fail
while the run still exits 0. And without a CUDA device it exits 1 and
prints no result."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _main():
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def test_main_catches_only_in_its_final_handler():
    main = _main()
    handlers = [n for n in ast.walk(main) if isinstance(n, ast.ExceptHandler)]
    assert len(handlers) == 1, [h.lineno for h in handlers]
    (handler,) = handlers
    last = handler.body[-1]
    assert isinstance(last, ast.Return)
    assert isinstance(last.value, ast.Constant) and last.value.value == 1
    # the handler belongs to the last try statement of main's body
    tries = [n for n in main.body if isinstance(n, ast.Try)]
    assert tries and handler in tries[-1].handlers


def test_without_cuda_exits_1_and_prints_no_result():
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    assert '"ok"' not in res.stdout and "kernels" not in res.stdout
