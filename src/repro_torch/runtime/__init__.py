"""Fault tolerance for the training loop (the port's copy of
``repro.runtime.fault_tolerance``)."""
from .fault_tolerance import (FailureInjector, SimulatedFailure, StepRecord,
                              StragglerMonitor, TrainSupervisor)

__all__ = ["FailureInjector", "SimulatedFailure", "StepRecord",
           "StragglerMonitor", "TrainSupervisor"]
