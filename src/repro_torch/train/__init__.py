"""Training: the chunked loss and the train step (the port of ``repro.train``)."""
