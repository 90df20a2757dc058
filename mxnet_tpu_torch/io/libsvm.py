"""LibSVM text-format reader and batch iterator (the port's counterpart
of ``mxnet_tpu/io/libsvm.py``).

Parity: ``src/io/iter_libsvm.cc`` (LibSVMIter with ``data_libsvm``,
``data_shape``, optional ``label_libsvm``, ``num_parts``/``part_index``
sharding) feeding ``example/sparse/linear_classification.py``.

The wire format is plain text, one example per line::

    <label>[,<label>...] <index>:<value> <index>:<value> ...

Indices are zero-based (the reference's documented contract).  Batches
come out as ``CSRNDArray`` data — the row slice is taken host-side on
the stored numpy CSR triplet (IO is host work; the device only sees the
batch), so step cost scales with nnz per batch, not the corpus.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray.sparse import CSRNDArray
from .io import DataBatch, DataDesc, DataIter


def read_libsvm(path, num_features=None, label_width=1):
    """Parse a libsvm file → ``(data, indices, indptr, labels)`` numpy
    CSR triplet + ``(n, label_width)`` label array."""
    vals, cols, indptr, labels = [], [], [0], []
    max_col = -1
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            # labels: first token(s) with no ':' — the reference packs
            # label_width labels comma- or space-separated at the front
            head = parts[0]
            feats_start = 1
            if "," in head:
                lab = [float(t) for t in head.split(",")]
            else:
                lab = [float(head)]
                while len(lab) < label_width and feats_start < len(parts) \
                        and ":" not in parts[feats_start]:
                    lab.append(float(parts[feats_start]))
                    feats_start += 1
            if len(lab) != label_width:
                raise MXNetError(
                    "libsvm %s:%d: %d labels (want %d)"
                    % (path, lineno, len(lab), label_width))
            labels.append(lab)
            for tok in parts[feats_start:]:
                try:
                    idx_s, val_s = tok.split(":", 1)
                    idx = int(idx_s)
                    val = float(val_s)
                except ValueError:
                    raise MXNetError("libsvm %s:%d: bad token %r"
                                     % (path, lineno, tok))
                if idx < 0:
                    raise MXNetError(
                        "libsvm %s:%d: negative feature index %d "
                        "(indices are ZERO-based)" % (path, lineno, idx))
                cols.append(idx)
                vals.append(val)
                max_col = max(max_col, idx)
            indptr.append(len(cols))
    if num_features is not None and max_col >= num_features:
        raise MXNetError(
            "libsvm %s: feature index %d out of range for data_shape "
            "width %d (indices are ZERO-based)" % (path, max_col,
                                                   num_features))
    return (np.asarray(vals, np.float32), np.asarray(cols, np.int64),
            np.asarray(indptr, np.int64),
            np.asarray(labels, np.float32))


class LibSVMIter(DataIter):
    """Batch iterator over libsvm files (parity: ``io.LibSVMIter``).

    ``data_shape`` is the per-example feature width ``(D,)``; data
    batches are ``CSRNDArray`` of shape ``(batch_size, D)``.  Labels
    come from the libsvm label column, or from a second
    ``label_libsvm`` file when the labels are themselves sparse/wide.
    ``num_parts``/``part_index`` shard the example stream for
    distributed training (contiguous split, like the reference's
    InputSplit).
    """

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_libsvm=None, label_shape=None, num_parts=1,
                 part_index=0, round_batch=True, **kwargs):
        super().__init__(batch_size)
        if len(tuple(data_shape)) != 1:
            raise MXNetError("LibSVMIter: data_shape must be (D,)")
        self._dim = int(tuple(data_shape)[0])
        label_width = int(np.prod(label_shape)) if label_shape else 1
        vals, cols, indptr, labels = read_libsvm(
            data_libsvm, self._dim, label_width=1 if label_libsvm
            else label_width)
        if label_libsvm is not None:
            lw = label_width
            lvals, lcols, lindptr, _ = read_libsvm(label_libsvm)
            n = len(lindptr) - 1
            dense_lab = np.zeros((n, lw), np.float32)
            for r in range(n):
                sl = slice(lindptr[r], lindptr[r + 1])
                dense_lab[r, lcols[sl].astype(np.int64)] = lvals[sl]
            labels = dense_lab
        n_total = len(indptr) - 1
        if labels.shape[0] != n_total:
            raise MXNetError("LibSVMIter: %d examples but %d labels"
                             % (n_total, labels.shape[0]))
        # contiguous shard for this part
        if not (0 <= part_index < num_parts):
            raise MXNetError("LibSVMIter: part_index out of range")
        per = -(-n_total // num_parts)
        lo, hi = part_index * per, min(n_total, (part_index + 1) * per)
        self._vals, self._cols, self._indptr = vals, cols, indptr
        self._labels = labels
        self._lo, self._hi = lo, hi
        self._round = round_batch
        self._label_width = labels.shape[1]
        self._cursor = lo
        self.provide_data = [DataDesc("data", (batch_size, self._dim))]
        self.provide_label = [DataDesc(
            "softmax_label",
            (batch_size,) if self._label_width == 1
            else (batch_size, self._label_width))]

    @property
    def num_examples(self):
        return self._hi - self._lo

    def reset(self):
        self._cursor = self._lo

    def _rows(self, row_ids):
        """CSR slice of the given example rows, on the host (one gather
        of the stored values, no loop over the rows)."""
        starts = self._indptr[row_ids]
        counts = (self._indptr[row_ids + 1] - starts).astype(np.int64)
        new_indptr = np.zeros(len(row_ids) + 1, np.int64)
        np.cumsum(counts, out=new_indptr[1:])
        take = np.repeat(starts - new_indptr[:-1], counts) \
            + np.arange(new_indptr[-1], dtype=np.int64)
        data = CSRNDArray(self._vals[take], new_indptr, self._cols[take],
                          (len(row_ids), self._dim))
        lab = self._labels[row_ids]
        if self._label_width == 1:
            lab = lab.reshape(-1)
        return data, NDArray(lab)

    def iter_next(self):
        return self._cursor < self._hi

    def next(self):
        if not self.iter_next():
            raise StopIteration
        end = self._cursor + self.batch_size
        ids = np.arange(self._cursor, min(end, self._hi))
        pad = 0
        if end > self._hi:
            pad = end - self._hi
            if len(ids) == 0:
                raise StopIteration
            # ALWAYS emit a full batch_size batch (the DataBatch pad
            # contract: consumers slice off the last `pad` rows, and
            # Module binds to the advertised (batch_size, D) shape).
            # round_batch wraps the filler to the shard's front (the
            # reference's epoch-wrapping semantics); otherwise the
            # filler repeats in-shard rows — either way the filler is
            # modulo-clamped so it can never leave this shard.
            fill_base = self._lo if self._round else ids[0]
            ids = np.concatenate(
                [ids,
                 self._lo + ((fill_base - self._lo + np.arange(pad))
                             % self.num_examples)])
        self._cursor = end
        data, label = self._rows(ids)
        return DataBatch(data=[data], label=[label], pad=pad,
                         index=ids.copy())

    def getpad(self):
        return max(0, self._cursor - self._hi)
