"""Whisper model: dims, modules and forward functions, weight conversion."""
