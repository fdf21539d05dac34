"""Roofline of one H100 (port of ``repro.roofline``): each kernel's work
and the card's peaks (``work``), one step counted on ``meta`` tensors
(``analysis``) and the report over every (arch x shape) cell
(``report``)."""
