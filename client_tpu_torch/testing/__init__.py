"""Test-support subsystems shipped with the port (importable by user test
suites, not only this repo's): the chaos fault-injection proxy that proves
the resilience layer end-to-end, the cell-scale ``ChaosCell`` grouping
that faults a whole replica group atomically, and the seeded byzantine
server wrapper whose responses LIE (healthy transport, corrupt payloads)
to prove the integrity layer against live wire bytes."""

from .byzantine import ByzantineHttpServer, ByzantinePlan
from .chaos import ChaosCell, ChaosProxy, Fault

__all__ = ["ByzantineHttpServer", "ByzantinePlan", "ChaosCell",
           "ChaosProxy", "Fault"]
