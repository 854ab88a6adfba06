"""Cross-request micro-batching for the /classify endpoint (the JAX
package's ``serve/batcher.py``).

  * One dispatcher thread drains everything queued the moment the device
    frees and runs ONE bucketed forward over the coalesced images. There
    is no batching window: under load the previous forward's duration is
    the window; an idle service dispatches a lone request at once.
  * A bounded image queue: a request that would overflow a non-empty
    queue is rejected up front (QueueFullError; HTTP 503).

Repairs over the JAX batcher:
  * no error ends the dispatcher thread: the whole per-batch body —
    stacking the images, the forward and handing out the results — is
    guarded, and requests whose images do not stack are served one by one,
    each with its own outcome (the JAX dispatcher died on an exception in
    batch assembly, and every later request hung);
  * ``submit`` rejects an image whose shape is not the classifier's
    ``input_shape`` with ValueError, for that request alone;
  * ``stop`` takes the queue under the lock before failing what is left,
    so each request is either served or failed, never both or neither;
  * :meth:`ClassifyBatcher.stats_snapshot` reads the counters under the
    lock, so /healthz never sees a half-updated batch.

The forward runs outside the queue's lock, behind the service's
accelerator lock.
"""

from __future__ import annotations

import concurrent.futures
import threading
import traceback

import numpy as np


class QueueFullError(Exception):
    """Raised by submit() when the bounded image queue is full."""


def _fail(fut: concurrent.futures.Future, exc: BaseException) -> None:
    if not fut.done():
        fut.set_exception(exc)


class ClassifyBatcher:
    """Coalesces concurrent classification requests into device batches.

    classifier: models.infer.SpectrogramClassifier (its ``classify`` runs
    the bucketed forward); its ``input_shape``, where it has one, is what
    ``submit`` admits.
    accel_lock: the service's accelerator lock — batched forwards
    serialize against /process chain runs on the shared device.
    max_queue_images: admission bound (images, not requests).
    """

    def __init__(self, classifier, accel_lock: threading.Lock | None = None,
                 max_queue_images: int = 256):
        self.classifier = classifier
        self.accel_lock = accel_lock or threading.Lock()
        self.max_queue_images = max_queue_images
        shape = getattr(classifier, "input_shape", None)
        self._input_shape = tuple(shape) if shape is not None else None
        self._mu = threading.Condition(threading.Lock())
        self._pending: list[tuple[np.ndarray, concurrent.futures.Future]] = []
        self._pending_images = 0
        self._stopped = False
        # Counters, written and read under _mu (stats_snapshot).
        self.stats = {"batches": 0, "batched_images": 0, "max_batch": 0,
                      "rejected": 0}
        self._thread = threading.Thread(
            target=self._loop, name="classify-batcher", daemon=True)
        self._thread.start()

    # ------------------------------ client API ---------------------------

    def submit(self, images: np.ndarray) -> concurrent.futures.Future:
        """Enqueue one request's images; resolves to a list of per-image
        prediction dicts (models/infer.py classify schema). Raises
        ValueError for images of the wrong shape, QueueFullError when the
        queue is full, RuntimeError once stopped."""
        images = np.asarray(images, np.float32)
        if images.ndim == 3:
            images = images[None]
        if (self._input_shape is not None
                and images.shape[1:] != self._input_shape):
            raise ValueError(f"expected images of shape {self._input_shape}, "
                             f"got {images.shape[1:]}")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._mu:
            if self._stopped:
                raise RuntimeError("batcher is stopped")
            # Admission: reject only when adding to a NON-empty queue would
            # exceed the bound. A single over-sized request with an empty
            # queue is always admitted (the classifier chunks it), or it
            # could never be served.
            if (self._pending_images > 0
                    and self._pending_images + len(images)
                    > self.max_queue_images):
                self.stats["rejected"] += 1
                raise QueueFullError(
                    f"classification queue full "
                    f"({self._pending_images} images pending, "
                    f"bound {self.max_queue_images})")
            self._pending.append((images, fut))
            self._pending_images += len(images)
            self._mu.notify()
        return fut

    def classify(self, images: np.ndarray, timeout: float | None = None):
        """Synchronous convenience wrapper: submit + wait."""
        return self.submit(images).result(timeout)

    def stats_snapshot(self) -> dict:
        """A consistent copy of the counters."""
        with self._mu:
            return dict(self.stats)

    def stop(self) -> None:
        """Stop the dispatcher; requests still queued fail with
        RuntimeError. The batch in flight, if any, completes first."""
        with self._mu:
            self._stopped = True
            pending, self._pending = self._pending, []
            self._pending_images = 0
            self._mu.notify()
        self._thread.join(timeout=5)
        for _, fut in pending:
            _fail(fut, RuntimeError("batcher stopped"))

    # ------------------------------ dispatcher ---------------------------

    def _drain(self) -> list[tuple[np.ndarray, concurrent.futures.Future]]:
        with self._mu:
            while not self._pending and not self._stopped:
                self._mu.wait()
            batch, self._pending = self._pending, []
            self._pending_images = 0
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._drain()
            if not batch:
                return
            try:
                self._run(batch)
            except Exception as e:  # noqa: BLE001 — the thread must live on
                traceback.print_exc()
                for _, fut in batch:
                    _fail(fut, e)

    def _run(self, batch) -> None:
        """One forward over the batch's stacked images, its results handed
        out per request; requests that do not stack run one by one."""
        if len(batch) == 1:
            imgs = batch[0][0]
        else:
            try:
                imgs = np.concatenate([b for b, _ in batch])
            except ValueError:
                for item in batch:
                    self._run([item])
                return
        try:
            with self.accel_lock:
                results = self.classifier.classify(imgs)
            if len(results) != len(imgs):
                raise RuntimeError(f"classifier returned {len(results)} "
                                   f"results for {len(imgs)} images")
        except Exception as e:  # noqa: BLE001 — delivered per request
            for _, fut in batch:
                _fail(fut, e)
            return
        with self._mu:
            self.stats["batches"] += 1
            self.stats["batched_images"] += len(imgs)
            self.stats["max_batch"] = max(self.stats["max_batch"], len(imgs))
        i = 0
        for b, fut in batch:
            if not fut.done():
                fut.set_result(results[i:i + len(b)])
            i += len(b)
