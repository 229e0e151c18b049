"""Port parity, the top-level surface: every public name of
``multiverso_tpu`` (the names its ``__init__`` binds, and the submodules
it reaches lazily) has its counterpart in ``multiverso_tpu_torch`` (in
its ``__all__``, or as a lazy submodule), or is listed here as not
ported by design with ROADMAP's reason; the reference's command-line
flags are defined with the JAX package's types and defaults; and
``init(sync=...)`` sets the ``sync`` flag as the JAX ``init`` does."""

import ast
import importlib

import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.zoo import Zoo as TZoo

# ROADMAP.md, "Not ported, by design": none of these is bound by the JAX
# package's __init__ today; the set is here so that a JAX name added later
# has to be ported or listed
BY_DESIGN = {"make_optax_train_step", "JaxRendezvous", "platform"}

REFERENCE_FLAGS = ("ma", "sync", "backup_worker_ratio", "omp_threads",
                   "allocator_type", "allocator_alignment", "machine_file",
                   "port")


def _jax_public_names():
    """The names multiverso_tpu/__init__.py binds at its top level, and
    the lazy submodules its ``__getattr__`` serves."""
    tree = ast.parse(open(jmv.__file__).read())
    names, lazy = set(), set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Tuple):
                    lazy.update(ast.literal_eval(sub))
    return {n for n in names if not n.startswith("_")} | {"__version__"}, \
        lazy


def test_every_jax_name_is_ported_or_listed():
    names, lazy = _jax_public_names()
    assert {"Table", "Updater", "serving", "telemetry", "dashboard",
            "__version__"} <= names   # the parse found the module's names
    missing = sorted(n for n in names
                     if n not in tmv.__all__ and n not in BY_DESIGN)
    assert not missing, missing
    assert tmv.__version__ == jmv.__version__
    for name in sorted(lazy - BY_DESIGN):
        mod = getattr(tmv, name)
        assert mod is importlib.import_module(f"multiverso_tpu_torch.{name}")
    with pytest.raises(AttributeError):
        tmv.no_such_name


def test_exported_names_resolve_to_the_port():
    for name in tmv.__all__:
        if name == "__version__":
            continue
        obj = getattr(tmv, name)
        mod = getattr(obj, "__module__", None) or getattr(obj, "__name__", "")
        assert mod.startswith("multiverso_tpu_torch"), (name, mod)
    assert issubclass(tmv.AdamUpdater, tmv.Updater)
    assert issubclass(tmv.ArrayTable, tmv.Table)


@pytest.mark.parametrize("name", REFERENCE_FLAGS)
def test_reference_flags_have_the_jax_defaults(name):
    j, t = jconfig._registry[name], tconfig._registry[name]
    assert t.type is j.type and t.default == j.default, (name, t, j)
    assert t.help


def test_init_sync_sets_the_flag():
    try:
        tmv.init(device="cpu", sync=True, updater="sgd")
        assert tconfig.get_flag("sync") is True
        assert tconfig.get_flag("updater_type") == "sgd"
    finally:
        zoo = TZoo.get()
        if zoo.started:
            zoo.stop()
        tconfig.reset_flags()
    assert tconfig.get_flag("sync") is False
