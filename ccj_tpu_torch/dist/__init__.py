"""Many sequences at once: the batched dense fill (``batch``) and the
multi-process corpus driver (``corpus``)."""
