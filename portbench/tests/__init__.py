"""CPU tests of the benchmark (and, marked cuda, the controls on a card)."""
