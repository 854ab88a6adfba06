"""Host helpers: complex-as-pair arithmetic and stage timers."""
