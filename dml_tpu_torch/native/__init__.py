"""Host-side native code of the port: the batch JPEG loader (loader.py)."""
