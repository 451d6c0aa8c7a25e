"""The port's OpenAI-compatible model server (``server/openai.py``) and the
standard-library HTTP layer it runs on (``server/http_server.py``)."""
