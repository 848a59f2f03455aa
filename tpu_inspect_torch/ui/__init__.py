"""Thin interactive web client over the headless engine: the reference
tool's canvas/controls workflow (indexing_ui.py:565-1014) served as a
single-page app by a stdlib HTTP server, the port of :mod:`tpu_inspect.ui`.
All state lives in one InspectionSession; the browser is a view."""

from tpu_inspect_torch.ui.server import UIServer

__all__ = ["UIServer"]
