"""Test-support subsystems shipped with the port (importable by user test
suites, not only this repo's): the chaos fault-injection proxy that proves
the resilience layer end-to-end, and the cell-scale ``ChaosCell`` grouping
that faults a whole replica group atomically. The byzantine server wrapper
of ``client_tpu.testing`` is not part of the port yet."""

from .chaos import ChaosCell, ChaosProxy, Fault

__all__ = ["ChaosCell", "ChaosProxy", "Fault"]
