"""The port's tools (tools/*_torch.py) as modules, run in this process on
one CPU thread, for tests/test_torch_tool_*.py.  Needs no JAX."""

import contextlib
import importlib
import pathlib
import sys

import torch

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"


def load(name: str):
    """tools/<name>.py imported by its name, with tools/ on sys.path, so
    that the processes a tool spawns import it too."""
    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))
    return importlib.import_module(name)


@contextlib.contextmanager
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
