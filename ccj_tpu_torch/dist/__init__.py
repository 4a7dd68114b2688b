"""Many sequences at once: the batched dense fill (``batch``) and the
multi-process corpus driver (``corpus``); one sequence over several
devices: the row-sharded dense and packed fills (``wavefront``)."""
