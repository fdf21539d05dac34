"""Core DVFS simulator modules (port of ``repro.core``)."""
