from .tracer import (Tracer, get_tracer, set_tracer, trace_counter,
                     trace_instant, trace_span)

__all__ = ["Tracer", "get_tracer", "set_tracer", "trace_span",
           "trace_instant", "trace_counter"]
