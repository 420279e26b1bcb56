"""Known-positive fixture corpus for the analyzer suite, the port's copy of
``repro.check.fixtures``.

Each module here violates exactly the invariants its name says it does:
the test suite asserts the analyzers flag them.  The directory is excluded
from default ``repro_torch.check`` scans (see
``repro_torch.check.config.EXCLUDE_PARTS``): these are test subjects, not
product code.  It is named ``corpus``, not ``fixtures``: ``repro``'s own
default scan of ``src`` skips only paths under ``repro/check/fixtures/``
and its tests require that no scanned path contains ``check/fixtures``.
"""
