"""Model families ported so far: the paper's CTR model."""
