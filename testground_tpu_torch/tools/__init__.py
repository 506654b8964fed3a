"""Tools of the port that run on the card (microbenchmarks)."""
