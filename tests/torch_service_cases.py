"""Run the reference's verify-service, occupancy and device-pool cases
against the port.

`port_cases(module, names)` rebuilds every ``test_*`` function of a
reference test module over a copy of the module's globals in which `names`
(VerifyService, FakeClock, the lanes, DevicePool, tuning, ...) are the
port's, so the case's body, its stub backends and its helpers run as
written against drand_tpu_torch.  A case that still reaches a reference
object through a global is refused, so a name left out of `names` cannot
quietly keep testing the reference.
"""

import inspect
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
    g.update(names)
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) \
                and v.__module__ == module.__name__:
            g[k] = types.FunctionType(v.__code__, g, v.__name__,
                                      v.__defaults__, v.__closure__)
    left = sorted(k for k, v in g.items() if _from_reference(v))
    assert not left, f"{module.__name__}: reference names left {left}"
    return [(k, g[k]) for k in sorted(g)
            if k.startswith("test_") and callable(g[k]) and k not in skip]


def run_case(fn, request):
    """Call a case with the fixtures its signature names."""
    params = inspect.signature(fn).parameters
    fn(**{p: request.getfixturevalue(p) for p in params})
