"""Figures are drawn with matplotlib where it is installed.

The figure functions (``agents/analytics.py``, ``compare/workbench.py``,
``compare/experiment.py``, ``compare/rl_renderer.py``) import matplotlib
inside themselves, as the JAX package's do, and raise ``ImportError``
without it.  The flows that draw a figure as a side product call them
through ``figure_or_note``: without matplotlib (the card's machine has
none) they write every other output and print one line instead.
"""
from __future__ import annotations


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def figure_or_note(draw, *args, name: str) -> bool:
    """``draw(*args)`` and True; without matplotlib one printed line
    saying that ``name`` was not drawn, and False."""
    if not have_matplotlib():
        print(f"{name} not drawn: matplotlib is not installed")
        return False
    draw(*args)
    return True
