"""K4: one-token GQA decode attention against a KV cache."""
