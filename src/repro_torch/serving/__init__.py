from repro_torch.serving.batcher import BatchedServer, Request

__all__ = ["BatchedServer", "Request"]
