"""Percent of the traced window in idle gaps that no span of the program,
aten op or runtime call covers (labelled ``host`` or ``bench.*``); the
shorter gaps' unlabelled bucket is left out (``harness/phases.py``)."""
from harness.phases import unattributed_percent as read  # noqa: F401
