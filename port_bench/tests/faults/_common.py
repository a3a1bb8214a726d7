"""What the entries' faults share."""
import importlib


def perturbed(x):
    """``x`` with one entry moved by a tenth of its norm."""
    x = x.clone()
    x[x.numel() // 2] += 0.1 * x.norm()
    return x


def krylov_faults(step, init, solve):
    """The faults of a solver of ``krylov/cgls.py`` that returns (x, k),
    named by its step, its init(A, b, x0) and its entry point."""
    from trips_tpu_torch import krylov

    cgls = importlib.import_module("trips_tpu_torch.krylov.cgls")
    init_f, solve_f = getattr(cgls, init), getattr(krylov, solve)

    def half(A, b, x0):
        b = b.clone()
        b[b.numel() // 2:] = 0
        return init_f(A, b, x0)

    def altered(*a, **k):
        x, n = solve_f(*a, **k)
        return perturbed(x), n

    return [("unchanged step", cgls, step, lambda A, tol, s: s),
            ("half the data", cgls, init, half),
            ("answer altered", krylov, solve, altered)]


def solver_faults(module, name):
    """The faults of a regularized solver ``module.name(A, b, L, **k)``
    that returns ``(x, ...)``, each a replacement of that solver."""
    orig = getattr(module, name)

    def unchanged(A, b, L, **k):  # every step after the first a no-op
        return orig(A, b, L, **{**k, "n_iter": 1})

    def half(A, b, L, **k):
        b = b.clone()
        b[b.numel() // 2:] = 0
        return orig(A, b, L, **k)

    def altered(*a, **k):
        x, *rest = orig(*a, **k)
        return (perturbed(x), *rest)

    return [("unchanged step", module, name, unchanged),
            ("half the data", module, name, half),
            ("answer altered", module, name, altered)]
