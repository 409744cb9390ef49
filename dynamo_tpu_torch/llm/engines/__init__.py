"""Engine adapters behind the OpenAI pipeline."""
