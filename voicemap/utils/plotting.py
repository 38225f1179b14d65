"""Lazy matplotlib for the plotting branches of the experiment CLIs (off the
main path: nothing else in the package needs matplotlib)."""


def pyplot():
    """matplotlib.pyplot on the non-interactive Agg backend, or a clear
    error when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit(
            "plotting needs matplotlib, which is not installed; install it "
            "or drop the plotting option"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
