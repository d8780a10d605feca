"""Checks on the port's program: the counterpart of the IR-level part of
``repro.analysis`` (IR401–IR404, PAL205), ``analysis/irlint.py`` with its
targets and contract file in ``analysis/contracts.py``.

The reference's source-level linters (JAX1xx, PAL201–204, RACE3xx) already
scan ``src/repro_torch`` from the JAX package; they are not copied here.
"""
