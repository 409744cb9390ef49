"""The port's launcher (``dynamo_tpu_torch.launch.run``) against the JAX
package's for the same inputs, on the CPU: ``in=text``, ``in=stdin`` and
``in=batch:F`` with ``out=echo_core``, ``out=echo_full``, ``pystr:F`` and
``pytok:F`` over one ``tokenizer.json`` model directory. What each prints
or writes is an exact match. Unknown inputs, a malformed ``dyn://`` path
and the outputs the port does not serve yet (``out=dyn://``) are refused.
"""

import io
import json
import sys

import pytest

from dynamo_tpu.launch.run import amain as jax_amain
from dynamo_tpu_torch.launch import run as launcher

pytestmark = pytest.mark.anyio

PYSTR = '''
async def init(engine_args):
    global PREFIX
    PREFIX = engine_args["model_name"] + ":"

async def generate(request):
    yield PREFIX
    for word in request["messages"][-1]["content"].split():
        yield word.upper() + " "
'''

PYTOK = '''
async def generate(request):
    for tid in reversed(request["token_ids"]):
        yield {"token_ids": [tid]}
'''

OUTS = ["echo_core", "echo_full", "pystr", "pytok"]


@pytest.fixture
def engines(tmp_path):
    (tmp_path / "pystr.py").write_text(PYSTR)
    (tmp_path / "pytok.py").write_text(PYTOK)
    return {"echo_core": "out=echo_core", "echo_full": "out=echo_full",
            "pystr": f"out=pystr:{tmp_path / 'pystr.py'}",
            "pytok": f"out=pytok:{tmp_path / 'pytok.py'}"}


async def _run_both(argv, stdin_text, capsys, monkeypatch):
    """What each launcher prints for ``argv`` and the same stdin."""
    out = []
    for amain in (launcher.amain, jax_amain):
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
        await amain(list(argv))
        out.append(capsys.readouterr().out)
    return out


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("src", ["text", "stdin"])
async def test_text_and_stdin_match_jax(tiny_model_dir, engines, out, src,
                                        capsys, monkeypatch):
    lines = "hello tiny world\nthe quick  brown fox\n\nafter the gap\n"
    got, want = await _run_both(
        [f"in={src}", engines[out], "--model-path", tiny_model_dir,
         "--max-tokens", "6"], lines, capsys, monkeypatch)
    assert got == want
    # text stops at the empty line, stdin reads every line
    assert got.count("\n") == (2 if src == "text" else 3)


@pytest.mark.parametrize("out", OUTS)
async def test_batch_matches_jax(tiny_model_dir, engines, out, tmp_path,
                                 capsys, monkeypatch):
    src = tmp_path / "in.jsonl"
    rows = [{"text": "hello tiny world"},
            {"messages": [{"role": "system", "content": "be brief"},
                          {"role": "user", "content": "two words"}],
             "max_tokens": 3},
            {"prompt": "a prompt key", "temperature": 0.0},
            {"text": "the quick brown fox jumps", "max_tokens": 2}]
    src.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    results = []
    for i, amain in enumerate((launcher.amain, jax_amain)):
        dst = tmp_path / f"out{i}.jsonl"
        await amain([f"in=batch:{src}", engines[out], "--model-path",
                     tiny_model_dir, "--max-tokens", "5",
                     "--output-path", str(dst)])
        results.append([json.loads(x) for x in dst.read_text().splitlines()])
    assert results[0] == results[1]
    assert [r.get("response") is not None for r in results[0]] == \
        [True] * len(rows)


async def test_batch_default_output_path_and_bad_line(tiny_model_dir,
                                                      tmp_path):
    """A line that is not JSON is an error row, and the run exits 1 after
    writing every row to <input>.out.jsonl, as in the JAX launcher."""
    outs = []
    for i, amain in enumerate((launcher.amain, jax_amain)):
        src = tmp_path / f"in{i}.jsonl"
        src.write_text('{"text": "hello"}\nnot json\n')
        with pytest.raises(SystemExit) as e:
            await amain([f"in=batch:{src}", "out=echo_core",
                         "--model-path", tiny_model_dir])
        assert e.value.code == 1
        outs.append((tmp_path / f"in{i}.out.jsonl").read_text())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("io_args,match", [
    (["in=grpc"], "in= source"),
    (["in=dyn://ns/comp"], "in= source"),
    (["out=dyn://ns/comp/ep"], "out= engine"),
    (["out=jax"], "out= engine"),
    (["bogus"], "unrecognized"),
])
def test_unported_modes_are_refused(io_args, match):
    with pytest.raises(SystemExit, match=match):
        launcher.parse_io(io_args)


async def test_core_engines_need_a_model_path():
    for out in ("out=echo_core", "out=torch"):
        with pytest.raises(SystemExit, match="model-path"):
            await launcher.amain(["in=stdin", out])
