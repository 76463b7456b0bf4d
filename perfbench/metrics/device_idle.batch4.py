"""Percent of the traced window in which no kernel ran on the device."""
from harness.readers import idle_percent as read  # noqa: F401
