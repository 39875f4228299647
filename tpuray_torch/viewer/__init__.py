"""The browser viewer: a render thread and an HTTP server (server.py)
serving one page (ui.py)."""
