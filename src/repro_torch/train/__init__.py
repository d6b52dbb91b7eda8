"""The LM side's training path: optimizers, train steps, the fault-tolerant loop."""
