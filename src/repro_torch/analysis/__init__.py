"""Analysis of the sharded path: the analytic memory model
(:mod:`.memory_model`), the cost counter of a traced step
(:mod:`.hlo_cost`) and the roofline tables (:mod:`.roofline`)."""
