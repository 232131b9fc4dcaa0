"""What every kernel wrapper hands its launch: pointers of tensors that
stay alive until the launch is enqueued, on PyTorch's current stream.

The caching allocator gives a freed block only to work queued behind the
launch on the same stream (``kernels/_build.py::stream_ptr``).  A pointer
taken from a temporary (``x.contiguous().data_ptr()`` as a call argument)
lets the block go back to the allocator before the launch, where a later
temporary of the same call may take it; a second stream would let work
outside the launch's order take it.  These source checks keep both out of
the port: every ``data_ptr()`` is taken of a named tensor (a name, an
element of a named dict or tuple, or an attribute), and the package makes
no stream of its own.
"""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "fm_radio_tpu_torch"
SOURCES = sorted(p for d in ("kernels", "probes", "models", "parallel")
                 for p in (PKG / d).glob("*.py"))


def _temporaries(tree):
    """Lines where data_ptr() is called on the result of a call."""
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "data_ptr"
            and isinstance(node.func.value, ast.Call)]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: f"{p.parent.name}/"
                         f"{p.name}")
def test_no_pointer_of_a_temporary(path):
    """No wrapper passes a pointer of a tensor that nothing holds."""
    assert _temporaries(ast.parse(path.read_text())) == []


def test_the_check_finds_a_temporary():
    """The check itself: it flags the pattern it is there for."""
    src = "fn(x.contiguous().data_ptr(), y.data_ptr(), a['w'].data_ptr())"
    assert _temporaries(ast.parse(src)) == [1]


def test_no_stream_of_its_own():
    """Every launch goes to torch.cuda.current_stream (_build.stream_ptr):
    the port creates, switches or records no other stream."""
    words = ("torch.cuda.Stream(", "torch.cuda.stream(", "record_stream",
             "cudaStreamCreate", "non_blocking=True")
    hits = [(p.name, w) for p in PKG.rglob("*") if p.suffix in (
        ".py", ".cu", ".cuh") and "_build" not in p.parts
        for w in words if w in p.read_text()]
    assert hits == []
