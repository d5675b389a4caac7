"""FFmpeg RTSP camera simulator.

Spawns an ffmpeg subprocess that *serves* a looping video file over RTSP
(ffmpeg itself listens — no external RTSP server required), mirroring the
reference's simulator contract (ffmpeg_simulator.py:26-178):

  * stderr tailed into a bounded deque by a daemon thread,
  * a short post-start poll catches immediate exits,
  * stop() escalates terminate -> wait(5 s) -> kill,
  * the listen URL rewrites the stream URL's netloc to ``listen_host:port``
    (default 0.0.0.0:8554) and strips credentials with a warning.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import threading
import time
from collections import deque
from typing import Deque, List, Optional
from urllib.parse import urlparse, urlunparse

from ..config import FFmpegSimulatorConfig, StreamConfig

logger = logging.getLogger(__name__)

_STDERR_LINES = 50
_DEFAULT_PORT = 8554


class FFmpegStreamError(RuntimeError):
    """ffmpeg failed to start or exited unexpectedly."""


class FFmpegStreamSimulator:
    def __init__(self, stream: StreamConfig, config: FFmpegSimulatorConfig):
        self.stream = stream
        self.config = config
        self._process: Optional[subprocess.Popen] = None
        self._stderr_tail: Deque[str] = deque(maxlen=_STDERR_LINES)
        self._reader: Optional[threading.Thread] = None

    @property
    def running(self) -> bool:
        return self._process is not None and self._process.poll() is None

    def start(self) -> None:
        if self.running:
            return
        if shutil.which("ffmpeg") is None:
            raise FFmpegStreamError("ffmpeg binary not found on PATH")
        cmd = self._build_command()
        logger.info("Starting ffmpeg simulator for '%s': %s",
                    self.stream.name, " ".join(cmd))
        self._process = subprocess.Popen(
            cmd,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
            text=True,
        )
        self._reader = threading.Thread(
            target=self._tail_stderr, name=f"ffmpeg-{self.stream.name}", daemon=True
        )
        self._reader.start()
        # catch immediate startup failures
        deadline = time.time() + 1.0
        while time.time() < deadline:
            if self._process.poll() is not None:
                raise FFmpegStreamError(
                    f"ffmpeg for stream '{self.stream.name}' exited immediately "
                    f"(rc={self._process.returncode}): "
                    + " | ".join(list(self._stderr_tail)[-5:])
                )
            time.sleep(0.1)

    def stop(self) -> None:
        proc, self._process = self._process, None
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            logger.warning(
                "ffmpeg for '%s' ignored SIGTERM; killing", self.stream.name
            )
            proc.kill()
            proc.wait(timeout=5.0)

    def _tail_stderr(self) -> None:
        proc = self._process
        if proc is None or proc.stderr is None:
            return
        for line in proc.stderr:
            line = line.rstrip()
            if line:
                self._stderr_tail.append(line)
                logger.debug("[ffmpeg %s] %s", self.stream.name, line)

    def _build_command(self) -> List[str]:
        cfg = self.config
        cmd: List[str] = ["ffmpeg", "-loglevel", cfg.log_level, "-nostdin"]
        if cfg.loop:
            cmd += ["-stream_loop", "-1"]
        cmd += ["-re", "-i", cfg.input]
        codec = cfg.video_codec or "copy"
        cmd += ["-c:v", codec]
        if codec == "libx264":
            cmd += ["-preset", "veryfast", "-tune", "zerolatency"]
        if cfg.audio_enabled:
            cmd += ["-c:a", cfg.audio_codec]
        else:
            cmd += ["-an"]
        cmd += list(cfg.extra_args or [])
        cmd += [
            "-f", "rtsp",
            "-rtsp_transport", "tcp",
            "-muxdelay", "0.1",
            "-listen", "1",
            self._build_listen_url(),
        ]
        return cmd

    def _build_listen_url(self) -> str:
        parsed = urlparse(self.stream.url)
        if parsed.scheme.lower() != "rtsp":
            raise FFmpegStreamError(
                f"Stream '{self.stream.name}': simulator serves RTSP only, "
                f"got '{parsed.scheme}'"
            )
        if parsed.username or parsed.password:
            logger.warning(
                "Stream '%s': credentials in url are ignored by the simulator",
                self.stream.name,
            )
        host = self.config.listen_host or "0.0.0.0"
        port = parsed.port or _DEFAULT_PORT
        netloc = f"{host}:{port}"
        return urlunparse(parsed._replace(netloc=netloc))
