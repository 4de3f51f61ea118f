"""Run the reference's verify-service, occupancy and device-pool cases
against the port.

`port_cases(module, names)` rebuilds every ``test_*`` function of a
reference test module over a copy of the module's globals in which `names`
(VerifyService, FakeClock, the lanes, DevicePool, tuning, ...) are the
port's, so the case's body, its stub backends and its helpers run as
written against drand_tpu_torch.  A case that still reaches a reference
object through a global is refused, so a name left out of `names` cannot
quietly keep testing the reference.

A case that imports reference modules in its body runs under
`port_imports(fn)`: while it runs, an absolute import of ``drand_tpu`` or a
``drand_tpu.<module>`` names the port's module at the same path (the
reference's ``crypto/tbls.py`` is the port's ``crypto/host/tbls.py``).
"""

import builtins
import contextlib
import functools
import importlib
import inspect
import threading
import types


def _from_reference(value) -> bool:
    mod = value.__name__ if isinstance(value, types.ModuleType) \
        else getattr(value, "__module__", None)
    return isinstance(mod, str) and (mod == "drand_tpu"
                                     or mod.startswith("drand_tpu."))


def port_cases(module, names, skip=()):
    """[(name, function)] for the test_* functions of `module` not in
    `skip`, each bound to the module's globals with `names` swapped in."""
    g = dict(vars(module))
    # a default argument that is a swapped global takes the port's value
    swap = {id(vars(module)[k]): v for k, v in names.items()
            if k in vars(module)}
    g.update(names)
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) \
                and v.__module__ == module.__name__:
            defaults = v.__defaults__ and tuple(
                swap.get(id(d), d) for d in v.__defaults__)
            g[k] = types.FunctionType(v.__code__, g, v.__name__,
                                      defaults, v.__closure__)
    left = sorted(k for k, v in g.items() if _from_reference(v))
    assert not left, f"{module.__name__}: reference names left {left}"
    return [(k, g[k]) for k in sorted(g)
            if k.startswith("test_") and callable(g[k]) and k not in skip]


def run_case(fn, request):
    """Call a case with the fixtures its signature names."""
    params = inspect.signature(fn).parameters
    fn(**{p: request.getfixturevalue(p) for p in params})


# reference module -> the port's module where the port keeps it elsewhere
MOVED = {"drand_tpu.crypto.tbls": "drand_tpu_torch.crypto.host.tbls"}
_import_lock = threading.Lock()


def _port_name(name: str) -> str:
    if name in MOVED:
        return MOVED[name]
    if name == "drand_tpu" or name.startswith("drand_tpu."):
        return "drand_tpu_torch" + name[len("drand_tpu"):]
    return name


@contextlib.contextmanager
def _ported_imports():
    orig = builtins.__import__

    def imp(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and _port_name(name) != name:
            port = _port_name(name)
            if not fromlist:
                # `import drand_tpu.x` binds the top package
                importlib.import_module(port)
                return orig("drand_tpu_torch", globals, locals, (), 0)
            mod = orig(port, globals, locals, fromlist, 0)
            moved = [f for f in fromlist if f"{name}.{f}" in MOVED]
            if not moved:
                return mod
            # `from drand_tpu.crypto import tbls`: the port keeps it
            # elsewhere, so hand the statement a module that has it
            view = types.ModuleType(port)
            view.__dict__.update(vars(mod))
            for f in moved:
                setattr(view, f, importlib.import_module(
                    MOVED[f"{name}.{f}"]))
            return view
        return orig(name, globals, locals, fromlist, level)

    with _import_lock:
        builtins.__import__ = imp
        try:
            yield
        finally:
            builtins.__import__ = orig


def port_imports(fn):
    """`fn` with its body's absolute drand_tpu imports naming the port."""
    @functools.wraps(fn)
    def run(*args, **kw):
        with _ported_imports():
            return fn(*args, **kw)
    return run
