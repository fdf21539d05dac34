"""The DVFS runtime (port of ``repro.dvfs_runtime``): arch-derived step
programs (``telemetry``), the per-job manager (``manager``) and the
streaming service (``service``), all over the port's ``GridExecutor``."""
