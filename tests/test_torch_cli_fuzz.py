"""The project generator over messy CSVs, port against reference.

The contracts of the JAX package's tests/test_cli_fuzz.py on the port:
type inference over adversarial columns (unicode headers,
numeric-looking strings with junk cells, all-null and constant columns,
free text, sparse emails), then the generated project's train and score
scripts RUN as generated, with ``build_workflow`` asked for the CPU.
For the same CSV the generated files are text-equal to the JAX
package's apart from the package name and the device seam.

The two seeds' trains run as one-thread child processes started
together by a module fixture.  The hashed text makes about 1 550
columns; the default grids' depth-12 trees over them stay cheap on the
CPU because its tree learner builds only a level's occupied nodes.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

from test_torch_cli import (
    _finish,
    _port_text,
    _run,
    start_projects,
)
from torch_parity import REF, mod

from transmogrifai_tpu_torch.cli import generate

SEEDS = (71, 72)

_WORDS = ("lorem ipsum dolor sit amet consectetur adipiscing elit sed do "
          "eiusmod tempor incididunt labore magna aliqua enim minim veniam "
          "quis nostrud exercitation").split()


def _messy_csv(path, rng, n=80):
    import csv

    cols = {
        "id": [f"row-{i}" for i in range(n)],
        "amount": [
            ("" if rng.rand() < 0.1 else
             ("N/A" if rng.rand() < 0.05 else f"{rng.randn() * 10 + 50:.3f}"))
            for _ in range(n)
        ],
        "catégorie": [
            ["rouge", "vert", "bleu", " vert "][rng.randint(4)]
            for _ in range(n)
        ],
        "all_null": ["" for _ in range(n)],
        "constant": ["same" for _ in range(n)],
        "freetext": [
            " ".join(_WORDS[rng.randint(len(_WORDS))]
                     for _ in range(rng.randint(2, 7)))
            for _ in range(n)
        ],
        "email": [
            (f"user{i}@example.com" if rng.rand() > 0.2 else "")
            for i in range(n)
        ],
    }
    label = (rng.rand(n) > 0.5).astype(int)
    cols["target"] = [str(v) for v in label]
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(cols.keys())
        for i in range(n):
            w.writerow([cols[k][i] for k in cols])
    return str(path)



#: name -> (csv writer, generate kwargs) for each seed
PROJECTS = {f"messy{seed}": (_messy_csv, dict(
    response="target", name="MessyApp", id_col="id")) for seed in SEEDS}


def _seed_rng(name: str):
    return np.random.RandomState(int(name[len("messy"):]))


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    yield from start_projects(tmp_path_factory.mktemp("fuzz"), PROJECTS,
                              _seed_rng)


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_on_messy_csv_and_run_training(projects, seed):
    p = projects[f"messy{seed}"]
    if "result" not in p:
        p["result"] = _finish(p["proc"], timeout=1200.0)
    rc, _out, err = p["result"]
    assert rc == 0, err[-3000:]
    assert os.path.exists(p["main"])
    assert os.path.isdir(os.path.join(p["dir"], "model"))
    # the batch scorer script runs against the SAME csv (label-free path)
    rc, _out2, err2 = _run(p["dir"], "score", [p["csv"]])
    assert rc == 0, err2[-2000:]


@pytest.mark.parametrize("seed", SEEDS)
def test_messy_generation_equal_to_reference(tmp_path, seed):
    """Over the same messy CSV the port's generator infers the reference's
    types and writes the reference's files, but for the seams."""
    csv_path = _messy_csv(str(tmp_path / "messy.csv"),
                          np.random.RandomState(seed))
    kw = dict(response="target", name="MessyApp", id_col="id")
    generate(input_path=csv_path, output=str(tmp_path / "port"), **kw)
    mod(REF, "cli").generate(input_path=csv_path,
                             output=str(tmp_path / "ref"), **kw)
    for fname in sorted(os.listdir(tmp_path / "ref")):
        got = (tmp_path / "port" / fname).read_text(encoding="utf-8")
        want = (tmp_path / "ref" / fname).read_text(encoding="utf-8")
        assert got == _port_text(want), fname
