"""Seeded mutants of the 256^2 JPEG 2000 fixtures (tests/data/textures,
make_fixtures.py): bit flips anywhere and cuts, read by the port's
read_texture and by Pillow through OpenJPEG 2.5.4.  OpenJPEG reads most
damaged streams to other pixels without a word; the port follows it, so a
mutant is read byte-equal to Pillow or refused where Pillow refuses it."""

import os
import shutil
import subprocess
import sys

import pytest

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "textures")
FIXTURES_256 = ("mushroom256_53.jp2", "mushroom256_rpcl.j2k")
pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build with")


MUTANT_SCRIPT = r"""
import io, sys, warnings
import numpy as np
from PIL import Image
from gaussian_splatterer_tpu_torch.io.image import read_texture

warnings.simplefilter("ignore")
rng = np.random.default_rng(27)
counts = {"equal": 0, "both_refuse": 0, "deviations": 0}
half = int(sys.argv[1])  # this process reads the mutants of this parity
for path in sys.argv[2:]:
    blob = open(path, "rb").read()
    mutants = []
    for _ in range(200):
        b = bytearray(blob)
        bit = int(rng.integers(0, len(b) * 8))
        b[bit // 8] ^= 1 << (bit % 8)
        mutants.append(bytes(b))
    mutants += [blob[:int(len(blob) * k / 17)] for k in range(1, 17)]
    for b in mutants[half::2]:
        try:
            want = np.asarray(Image.open(io.BytesIO(b)).convert("RGBA"))
        except Exception:
            want = None
        try:
            got = read_texture(b)[1]
        except ValueError:
            got = None
        if want is None and got is None:
            counts["both_refuse"] += 1
        elif want is not None and got is not None and np.array_equal(want, got):
            counts["equal"] += 1
        else:
            counts["deviations"] += 1
print(counts)
"""


def test_mutants_read_as_pillow_reads_them_in_subprocesses(tmp_path):
    """200 seeded bit flips and 16 cuts of each 256^2 fixture, each half of
    a fixture's mutants in a subprocess of its own, the four run side by
    side (a crash in the C++ fails this test only): each mutant reads
    byte-equal to Pillow or is refused where Pillow refuses it."""
    script = tmp_path / "mutants.py"
    script.write_text(MUTANT_SCRIPT)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), str(half),
                               os.path.join(FIXTURES, name)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=root) for name in FIXTURES_256 for half in (0, 1)]
    total = {"equal": 0, "both_refuse": 0, "deviations": 0}
    for proc in procs:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-2000:]
        counts = eval(out.strip().splitlines()[-1])  # noqa: S307 (our own dict literal)
        assert sum(counts.values()) == 108
        for key in total:
            total[key] += counts[key]
    assert total["deviations"] == 0
    assert total["equal"] > 300 and total["both_refuse"] > 16
