"""Live-transcription HTTP client for the /v1/stream endpoint of the
PyTorch/CUDA port's server (`examples/live_http_client.py`, with the
port's audio reader).

The whole live-serving loop over plain HTTP, stdlib only: upload raw mono
16 kHz int16 PCM with chunked transfer-encoding (as a microphone would
deliver it) and print each segment the moment the server finalizes its
30 s window, then the {"done": true, ...} summary. Segments are read in a
background thread WHILE the upload continues — live captions, one socket.

Start the port's server on the card first (random weights work offline):

    python -m whisper_at_tpu_torch.serving --random --model tiny --port 8080 \
        --language en

then:

    python examples/live_http_client_torch.py audio.wav --port 8080
    python examples/live_http_client_torch.py --synthetic 65 --port 8080

The client runs no model and needs no card; it takes the examples'
`--device` flag and ignores it.

Any number of concurrent clients may stream at once — the server batches
their window decodes/mels/tag passes on the device (StreamingService).
"""

import argparse
import http.client
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pcm16_blocks(args):
    """Yield int16 PCM blocks at the requested granularity."""
    if args.audio:
        from whisper_at_tpu_torch.audio import load_audio_pcm16

        pcm = load_audio_pcm16(args.audio)
        if pcm.dtype != np.int16:
            pcm = (np.clip(pcm, -1, 1) * 32767.0).astype(np.int16)
    else:
        t = np.arange(int(16000 * args.synthetic)) / 16000.0
        x = 0.4 * np.sin(2 * np.pi * 330 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0)
        pcm = (x * 32767.0).astype(np.int16)
    block = int(16000 * args.block_seconds)
    for lo in range(0, len(pcm), block):
        yield pcm[lo:lo + block].tobytes()


def print_stream(resp):
    """Consume NDJSON lines as the server emits them."""
    while True:
        line = resp.readline()
        if not line:
            return
        msg = json.loads(line)
        if msg.get("done"):
            print(f"\n== done ==\ntext: {msg['text']!r}\n"
                  f"language: {msg['language']}")
            for seg_tags in msg.get("audio_tags", [])[:3]:
                print("tags:", seg_tags)
            return
        if "error" in msg:
            print("server error:", msg["error"], file=sys.stderr)
            return
        print(f"[{msg['start']:7.2f} -> {msg['end']:7.2f}] {msg['text']}",
              flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("audio", nargs="?", default=None)
    parser.add_argument("--synthetic", type=float, default=None,
                        metavar="SECONDS",
                        help="generate a test tone instead of reading a file")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--block-seconds", type=float, default=0.25,
                        help="upload granularity (a mic callback cadence)")
    parser.add_argument("--realtime", action="store_true",
                        help="pace the upload at real time instead of "
                             "as-fast-as-possible")
    parser.add_argument("--tags", type=int, default=3)
    parser.add_argument("--device", default="cuda",
                        help="ignored: the model runs in the server")
    parser.add_argument("--query", default="",
                        help="extra query params, e.g. "
                             "'language=en&word_timestamps=true'")
    args = parser.parse_args()
    if not args.audio and args.synthetic is None:
        parser.error("give an audio file or --synthetic SECONDS")

    qs = f"tags={args.tags}" + (f"&{args.query}" if args.query else "")
    conn = http.client.HTTPConnection(args.host, args.port, timeout=600)
    conn.putrequest("POST", f"/v1/stream?{qs}")
    conn.putheader("Transfer-Encoding", "chunked")
    conn.putheader("Content-Type", "audio/pcm16")
    conn.endheaders()
    resp = conn.getresponse()  # headers arrive as soon as the session opens
    assert resp.status == 200, resp.status

    reader = threading.Thread(target=print_stream, args=(resp,))
    reader.start()
    # upload on the main thread; the response thread prints segments live
    # (conn's request state machine is bypassed with raw socket sends,
    # which is exactly what chunked framing is)
    try:
        for data in pcm16_blocks(args):
            conn.sock.sendall(b"%x\r\n" % len(data) + data + b"\r\n")
            if args.realtime:
                time.sleep(args.block_seconds)
        conn.sock.sendall(b"0\r\n\r\n")
    except OSError:
        # server closed mid-stream (its error line explains why — the
        # reader thread prints it); stop uploading, keep reading
        pass
    reader.join()
    conn.close()


if __name__ == "__main__":
    main()
