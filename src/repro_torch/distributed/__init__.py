"""Serving on one device; training on one device or over the data ranks of
a process mesh (``collectives``, ``sharding``).  ``admission`` is a
verbatim copy of the JAX package's framework-free module (numpy only)."""
from .serve import Server, ServeConfig
from .async_trainer import AsyncConfig, AsyncTrainer
from .slot_serve import (SlotServer, SlotConfig, ServeResult,
                         RetryPolicy, OverloadPolicy, ServePreempted,
                         SHED_POLICIES)
from .admission import (AdmissionPolicy, AdmissionTrace, draw_arrivals,
                        parse_admission)

__all__ = ["Server", "ServeConfig", "AsyncConfig", "AsyncTrainer",
           "SlotServer", "SlotConfig", "ServeResult", "RetryPolicy",
           "OverloadPolicy", "ServePreempted", "SHED_POLICIES",
           "AdmissionPolicy", "AdmissionTrace", "draw_arrivals",
           "parse_admission"]
