"""``paddle.text`` (port of ``paddle_tpu/text/__init__.py``): Viterbi
decoding (``viterbi_decode``, ``ViterbiDecoder``), the decoder of CRF
taggers, and the text datasets (``UCIHousing``, ``Imdb``, ``Imikolov``,
``Movielens``, ``WMT14``, ``WMT16``, ``Conll05st``).

``viterbi_decode`` runs on its inputs' device: one step of torch ops a
time step, no host synchronisation inside the loop. The tags ``n`` and
``n + 1`` of a ``[n + 2, n + 2]`` transition matrix are BOS and EOS when
``include_bos_eos_tag``. Past a sequence's length its scores are held and
the backtrack stays on its last tag, as in the reference; ties go to the
first index (``argmax``); paths are int64.

The datasets are host code reading the reference's cache layout
(``~/.cache/paddle/dataset/<archive>``) with the standard library; a
missing archive raises ``IOError`` naming the path (nothing is
downloaded). ``UCIHousing(synthetic=N)`` draws a deterministic stand-in
from ``RandomState(0)``, the reference's draws.
"""
from __future__ import annotations

import gzip
import os
import re
import tarfile
import zipfile
from collections import Counter

import numpy as np
import torch

from .._cache import dataset_cache_path
from ..io import Dataset
from ..ops._util import as_tensor

__all__ = ["ViterbiDecoder", "viterbi_decode", "UCIHousing", "Imdb",
           "Imikolov", "Movielens", "WMT14", "WMT16", "Conll05st",
           "Conll05"]


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True, name=None):
    """Viterbi decoding of emission scores ``potentials [B, T, N]`` under
    ``transition_params [N(+2), N(+2)]`` (``[i, j]``: from tag ``i`` to
    ``j``). Returns ``(scores [B], paths [B, T] int64)``."""
    emis = as_tensor(potentials)
    trans = as_tensor(transition_params, emis).to(emis.device)
    b, t, n = emis.shape
    lens = (torch.full((b,), t, dtype=torch.int64, device=emis.device)
            if lengths is None else as_tensor(lengths, emis).to(emis.device))
    if include_bos_eos_tag:
        # start scores from BOS's row, stop scores from EOS's column
        start, stop, core = trans[n, :n], trans[:n, n + 1], trans[:n, :n]
    else:
        start = torch.zeros(n, dtype=emis.dtype, device=emis.device)
        stop, core = start, trans
    alpha = emis[:, 0] + start[None, :]                      # [B, N]
    backptrs = []
    for step in range(1, t):
        scores = alpha[:, :, None] + core[None]              # [B, N, N]
        backptrs.append(scores.argmax(1))
        new = scores.amax(1) + emis[:, step]
        alpha = torch.where((step < lens)[:, None], new, alpha)
    alpha = alpha + stop[None, :]
    tag = alpha.argmax(-1)
    score = alpha.amax(-1)
    path = [tag]
    for step in range(t - 1, 0, -1):
        prev = backptrs[step - 1].gather(1, tag[:, None])[:, 0]
        tag = torch.where(step < lens, prev, tag)
        path.append(tag)
    return score, torch.stack(path[::-1], dim=1).to(torch.int64)


class ViterbiDecoder:
    """``paddle.text.ViterbiDecoder``: :func:`viterbi_decode` with its
    transitions held."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


class _CachedDataset(Dataset):
    """A text dataset read from its archive in the dataset cache (or
    ``data_file``); a miss raises ``IOError`` naming the path."""

    _filename = None      # the archive's name in the cache

    def __init__(self, data_file=None, mode="train", **kw):
        self.mode = mode
        if data_file is None:
            data_file = dataset_cache_path(self._filename)
        if not os.path.exists(data_file):
            raise IOError(
                f"{type(self).__name__}: nothing is downloaded: place the "
                f"archive at {data_file}")
        self.data_file = data_file
        self._load()

    def _load(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class UCIHousing(_CachedDataset):
    """Boston-housing regression rows (13 features, 1 target). Pass
    ``synthetic=N`` to generate a deterministic stand-in dataset."""

    _filename = "housing.data"

    def __init__(self, data_file=None, mode="train", synthetic=None, **kw):
        if synthetic:
            rng = np.random.RandomState(0)
            feats = rng.rand(int(synthetic), 13).astype("float32")
            w = rng.rand(13, 1).astype("float32")
            tgt = feats @ w + 0.1 * rng.rand(int(synthetic), 1)
            self.mode = mode
            self.samples = [(feats[i], tgt[i].astype("float32"))
                            for i in range(int(synthetic))]
            return
        super().__init__(data_file, mode, **kw)

    def _load(self):
        raw = np.loadtxt(self.data_file).astype("float32")
        split = int(0.8 * len(raw))
        rows = raw[:split] if self.mode == "train" else raw[split:]
        mu, sigma = raw[:, :13].mean(0), raw[:, :13].std(0) + 1e-8
        self.samples = [(((r[:13] - mu) / sigma).astype("float32"),
                         r[13:14].astype("float32")) for r in rows]


class Imdb(_CachedDataset):
    """IMDB sentiment archive (aclImdb_v1.tar.gz)."""

    _filename = "aclImdb_v1.tar.gz"

    _vocab_cache = {}     # data_file -> word_idx (one archive pass)

    def _load(self):
        any_pat = re.compile(r"aclImdb/(train|test)/(pos|neg)/.*\.txt$")
        tok_pat = re.compile(r"[a-z']+")
        # frequency-sorted vocab over the WHOLE archive so train and test
        # instances share word ids (reference build_dict); cached per
        # archive so the second split skips the full decode pass
        cached = Imdb._vocab_cache.get(self.data_file)
        freq = Counter() if cached is None else None
        mode_docs = []
        with tarfile.open(self.data_file) as tf:
            for m in tf.getmembers():
                match = any_pat.match(m.name)
                if not match:
                    continue
                in_mode = match.group(1) == self.mode
                if freq is None and not in_mode:
                    continue            # vocab cached: only read our split
                text = tf.extractfile(m).read().decode(
                    "utf-8", "ignore").lower()
                toks = tok_pat.findall(text)
                if freq is not None:
                    freq.update(toks)
                if in_mode:
                    mode_docs.append(
                        (toks, 0 if match.group(2) == "pos" else 1))
        if cached is None:
            cached = {w: i for i, (w, _) in enumerate(
                sorted(freq.items(), key=lambda kv: (-kv[1], kv[0])))}
            Imdb._vocab_cache[self.data_file] = cached
        self.word_idx = cached
        self.samples = [([self.word_idx[t] for t in toks], lab)
                        for toks, lab in mode_docs]


class Imikolov(_CachedDataset):
    """PTB language-model n-grams (simple-examples.tgz)."""

    _filename = "simple-examples.tgz"

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", **kw):
        self.data_type = data_type
        self.window_size = window_size
        super().__init__(data_file, mode, **kw)

    def _load(self):
        with tarfile.open(self.data_file) as tf:
            # vocab ALWAYS from the train file (first-occurrence order) so
            # train/test instances share word ids (reference build_dict)
            train_text = tf.extractfile(
                "./simple-examples/data/ptb.train.txt").read().decode(
                "utf-8")
            self.word_idx = {"<eos>": 0, "<unk>": 1}
            for line in train_text.splitlines():
                for t in line.split():
                    self.word_idx.setdefault(t, len(self.word_idx))
            if self.mode == "train":
                text = train_text
            else:
                text = tf.extractfile(
                    f"./simple-examples/data/ptb.{self.mode}.txt"
                ).read().decode("utf-8")
        unk = self.word_idx["<unk>"]
        sents = []
        for line in text.splitlines():
            toks = line.split() + ["<eos>"]
            sents.append([self.word_idx.get(t, unk) for t in toks])
        if str(self.data_type).upper() == "SEQ":
            # reference SEQ mode: (src, trg) = (l[:-1], l[1:]) per sentence
            self.samples = [(s[:-1], s[1:]) for s in sents if len(s) > 1]
        else:
            out = []
            n = self.window_size
            for s in sents:
                for i in range(len(s) - n + 1):
                    out.append(tuple(s[i:i + n]))
            self.samples = out


class Movielens(_CachedDataset):
    """MovieLens-1M ratings (reference ``paddle.text.Movielens`` —
    ``ml-1m.zip`` with ``ratings.dat``/``users.dat``/``movies.dat``,
    ``::``-separated). Samples: (user_id, gender_id, age_id,
    occupation_id, movie_id, category_ids, title_ids, rating)."""

    _filename = "ml-1m.zip"

    AGES = [1, 18, 25, 35, 45, 50, 56]

    def _load(self):
        with zipfile.ZipFile(self.data_file) as z:
            root = "ml-1m/"
            names = z.namelist()
            if root + "ratings.dat" not in names:
                root = next((n[:-len("ratings.dat")] for n in names
                             if n.endswith("ratings.dat")), "")

            def lines(name):
                return z.read(root + name).decode(
                    "latin-1").strip().splitlines()

            users = {}
            for ln in lines("users.dat"):
                uid, gender, age, occ, _zip = ln.split("::")
                users[int(uid)] = (0 if gender == "M" else 1,
                                   self.AGES.index(int(age)), int(occ))
            cats, words = {}, {}
            movies = {}
            for ln in lines("movies.dat"):
                mid, title, genres = ln.split("::")
                cat_ids = [cats.setdefault(c, len(cats))
                           for c in genres.split("|")]
                tw = [words.setdefault(w, len(words))
                      for w in title.lower().split()]
                movies[int(mid)] = (cat_ids, tw)
            n = 0
            self.samples = []
            for ln in lines("ratings.dat"):
                uid, mid, rating, _ts = ln.split("::")
                uid, mid = int(uid), int(mid)
                if uid not in users or mid not in movies:
                    continue
                # reference split: 9:1 train/test round-robin
                is_test = n % 10 == 9
                n += 1
                if (self.mode == "test") != is_test:
                    continue
                g, a, o = users[uid]
                c, tw = movies[mid]
                self.samples.append((uid, g, a, o, mid, c, tw,
                                     float(rating)))
        self.categories_dict = cats
        self.movie_title_dict = words


class _WMTBase(_CachedDataset):
    """Shared WMT en↔de/fr pair loader: archives hold parallel line files;
    samples are (src_ids, trg_ids_with_bos, trg_ids_with_eos) like the
    reference's trainer feed. Vocab is frequency-sorted per language with
    <s>, <e>, <unk> reserved."""

    _src_suffix = None
    _trg_suffix = None

    BOS, EOS, UNK = 0, 1, 2

    def _build_vocab(self, lines, size):
        freq = Counter()
        for ln in lines:
            freq.update(ln.split())
        keep = [w for w, _ in sorted(freq.items(),
                                     key=lambda kv: (-kv[1], kv[0]))]
        vocab = {"<s>": self.BOS, "<e>": self.EOS, "<unk>": self.UNK}
        for w in keep[:max(size - 3, 0)]:
            vocab[w] = len(vocab)
        return vocab

    def _pairs_from_tar(self):
        src_lines, trg_lines = [], []
        want = self.mode  # train/test/dev naming inside the archives
        with tarfile.open(self.data_file) as tf:
            members = {m.name: m for m in tf.getmembers() if m.isfile()}
            src_name = next((n for n in sorted(members)
                             if want in n and n.endswith(self._src_suffix)),
                            None)
            trg_name = next((n for n in sorted(members)
                             if want in n and n.endswith(self._trg_suffix)),
                            None)
            if src_name is None or trg_name is None:
                raise IOError(
                    f"{type(self).__name__}: no '{want}' *{self._src_suffix}"
                    f"/*{self._trg_suffix} pair inside {self.data_file}")
            src_lines = tf.extractfile(members[src_name]).read().decode(
                "utf-8", "ignore").strip().splitlines()
            trg_lines = tf.extractfile(members[trg_name]).read().decode(
                "utf-8", "ignore").strip().splitlines()
        return src_lines, trg_lines

    def __init__(self, data_file=None, mode="train", src_dict_size=30000,
                 trg_dict_size=30000, lang=None, **kw):
        self._src_size = src_dict_size
        self._trg_size = trg_dict_size
        super().__init__(data_file, mode, **kw)

    def _load(self):
        src_lines, trg_lines = self._pairs_from_tar()
        if self.mode == "train":
            vs, vt = src_lines, trg_lines
        else:
            # vocab ALWAYS from the train pair so train/test share word
            # ids (same contract as Imdb/Imikolov above)
            saved = self.mode
            self.mode = "train"
            try:
                vs, vt = self._pairs_from_tar()
            finally:
                self.mode = saved
        self.src_dict = self._build_vocab(vs, self._src_size)
        self.trg_dict = self._build_vocab(vt, self._trg_size)

        def ids(ln, vocab):
            return [vocab.get(w, self.UNK) for w in ln.split()]

        self.samples = []
        for s, t in zip(src_lines, trg_lines):
            ti = ids(t, self.trg_dict)
            self.samples.append((ids(s, self.src_dict),
                                 [self.BOS] + ti, ti + [self.EOS]))


class WMT14(_WMTBase):
    """reference ``paddle.text.WMT14`` (en→fr)."""

    _filename = "wmt14.tgz"
    _src_suffix = ".en"
    _trg_suffix = ".fr"


class WMT16(_WMTBase):
    """reference ``paddle.text.WMT16`` (en↔de multi-lingual archive)."""

    _filename = "wmt16.tar.gz"
    _src_suffix = ".en"
    _trg_suffix = ".de"

    def __init__(self, data_file=None, mode="train", src_dict_size=30000,
                 trg_dict_size=30000, lang="en", **kw):
        if lang == "de":
            self._src_suffix, self._trg_suffix = ".de", ".en"
        super().__init__(data_file, mode, src_dict_size, trg_dict_size, **kw)


class Conll05st(_CachedDataset):
    """reference ``paddle.text.Conll05st`` — semantic role labeling rows.
    Expects the test split's column files (words / props) inside the
    archive; samples are (words, predicate, labels) id lists."""

    _filename = "conll05st-tests.tar.gz"

    def _load(self):
        with tarfile.open(self.data_file) as tf:
            members = {m.name: m for m in tf.getmembers() if m.isfile()}
            w_name = next((n for n in sorted(members) if "words" in n), None)
            p_name = next((n for n in sorted(members) if "props" in n), None)
            if w_name is None or p_name is None:
                raise IOError(f"Conll05st: words/props files not found in "
                              f"{self.data_file}")
            def read(name):
                raw = tf.extractfile(members[name]).read()
                if name.endswith(".gz"):
                    raw = gzip.decompress(raw)
                return raw.decode("utf-8", "ignore")
            sents, cur_w, cur_p = [], [], []
            for wln, pln in zip(read(w_name).splitlines(),
                                read(p_name).splitlines()):
                if not wln.strip():
                    if cur_w:
                        sents.append((cur_w, cur_p))
                    cur_w, cur_p = [], []
                    continue
                cur_w.append(wln.strip().lower())
                cur_p.append(pln.split())
            if cur_w:
                sents.append((cur_w, cur_p))
        # props format: col 0 = verb lemma or '-', cols 1..P = one label
        # column per predicate — ONE sample per predicate, tagged with
        # the predicate's token index
        raw = []
        for words, prows in sents:
            pred_rows = [i for i, pr in enumerate(prows) if pr[0] != "-"]
            n_pred = max(len(pr) for pr in prows) - 1
            for k in range(n_pred):
                labels = [pr[1 + k] if len(pr) > 1 + k else "*"
                          for pr in prows]
                pred_idx = pred_rows[k] if k < len(pred_rows) else 0
                raw.append((words, pred_idx, labels))
        self.word_dict = {w: i for i, w in enumerate(
            sorted({w for s, _, _ in raw for w in s}))}
        self.label_dict = {l: i for i, l in enumerate(
            sorted({l for _, _, ls in raw for l in ls}))}
        self.samples = [([self.word_dict[w] for w in s], p,
                         [self.label_dict[l] for l in ls])
                        for s, p, ls in raw]


Conll05 = Conll05st
