"""Runtime of the port: the LM serving loop, the fault-tolerant training
loop and its straggler policy."""
