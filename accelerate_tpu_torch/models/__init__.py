"""Model families of the port (Llama, for serving)."""
