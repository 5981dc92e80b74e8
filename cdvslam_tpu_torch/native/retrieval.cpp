// Bag-of-visual-words place recognition (native component).
//
// A copy of the JAX package's cdvslam_tpu/native/retrieval.cpp, built by
// the port's loop/retrieval.py into build/native/. It replaces the
// reference's DPRetrieval pybind module wrapping DBoW2 (reference:
// DPRetrieval/src/main.cpp:65-157). Same job:
// insert ORB descriptors per keyframe into a BoW database, query top-k
// similar frames with a temporal-radius exclusion, and brute-force
// Hamming-match descriptor pairs between two frames.
//
// Unlike DBoW2 (which needs a pretrained ORBvoc.txt), the vocabulary is
// built ONLINE: once enough descriptors accumulate, a hierarchical
// k-medoids tree (branching K, depth L) over 256-bit Hamming space is
// trained and all stored frames are (re)quantized. tf-idf weighted L1
// scoring with an inverted index, as in DBoW2.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <map>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

using Desc = std::array<uint64_t, 4>;  // 256-bit ORB descriptor

static inline int hamming(const Desc &a, const Desc &b) {
  int d = 0;
  for (int i = 0; i < 4; i++) d += __builtin_popcountll(a[i] ^ b[i]);
  return d;
}

static Desc majority(const std::vector<const Desc *> &group) {
  Desc out{0, 0, 0, 0};
  if (group.empty()) return out;
  int cnt[256] = {0};
  for (const Desc *d : group)
    for (int w = 0; w < 4; w++)
      for (int b = 0; b < 64; b++)
        if (((*d)[w] >> b) & 1ULL) cnt[w * 64 + b]++;
  const int half = (int)group.size() / 2;
  for (int i = 0; i < 256; i++)
    if (cnt[i] > half) out[i / 64] |= 1ULL << (i % 64);
  return out;
}

struct VocabNode {
  Desc center{};
  int children[16];  // up to K children; -1 terminated
  int word_id = -1;  // >= 0 for leaves
  VocabNode() { std::fill(children, children + 16, -1); }
};

struct Frame {
  long id;
  std::vector<Desc> descs;
  std::map<int, float> bow;  // word -> tf weight (idf applied at query)
};

struct Retrieval {
  int K = 8, L = 3;
  size_t train_threshold = 20000;
  bool trained = false;

  std::vector<VocabNode> nodes;
  int n_words = 0;
  std::vector<int> word_df;                      // document frequency
  std::vector<std::vector<int>> inverted;        // word -> frame indices

  std::vector<Frame> frames;
  std::unordered_map<long, int> id2idx;
  size_t n_descs = 0;
  std::mt19937 rng{1234};

  // ---- vocabulary -------------------------------------------------------
  int build_level(std::vector<const Desc *> &items, int depth) {
    int idx = (int)nodes.size();
    nodes.emplace_back();
    nodes[idx].center = majority(items);
    if (depth == L || (int)items.size() <= K) {
      nodes[idx].word_id = n_words++;
      return idx;
    }
    // k-medoids-ish: pick K random seeds, 4 Lloyd iterations w/ majority
    std::vector<Desc> centers(K);
    for (int k = 0; k < K; k++) centers[k] = *items[rng() % items.size()];
    std::vector<int> assign(items.size());
    for (int it = 0; it < 4; it++) {
      for (size_t i = 0; i < items.size(); i++) {
        int best = 0, bd = 1 << 30;
        for (int k = 0; k < K; k++) {
          int d = hamming(*items[i], centers[k]);
          if (d < bd) { bd = d; best = k; }
        }
        assign[i] = best;
      }
      for (int k = 0; k < K; k++) {
        std::vector<const Desc *> grp;
        for (size_t i = 0; i < items.size(); i++)
          if (assign[i] == k) grp.push_back(items[i]);
        if (!grp.empty()) centers[k] = majority(grp);
      }
    }
    for (int k = 0; k < K; k++) {
      std::vector<const Desc *> grp;
      for (size_t i = 0; i < items.size(); i++)
        if (assign[i] == k) grp.push_back(items[i]);
      if (grp.empty()) continue;
      int child = build_level(grp, depth + 1);
      for (int c = 0; c < 16; c++)
        if (nodes[idx].children[c] < 0) { nodes[idx].children[c] = child; break; }
    }
    if (nodes[idx].children[0] < 0) nodes[idx].word_id = n_words++;
    return idx;
  }

  int quantize(const Desc &d) const {
    int cur = 0;
    while (nodes[cur].word_id < 0) {
      int best = -1, bd = 1 << 30;
      for (int c = 0; c < 16 && nodes[cur].children[c] >= 0; c++) {
        int child = nodes[cur].children[c];
        int dist = hamming(d, nodes[child].center);
        if (dist < bd) { bd = dist; best = child; }
      }
      if (best < 0) break;
      cur = best;
    }
    return nodes[cur].word_id;
  }

  void compute_bow(Frame &f) {
    f.bow.clear();
    for (const Desc &d : f.descs) f.bow[quantize(d)] += 1.0f;
    float norm = 0;
    for (auto &kv : f.bow) norm += kv.second;
    for (auto &kv : f.bow) kv.second /= std::max(norm, 1.0f);
  }

  void train() {
    std::vector<const Desc *> all;
    for (auto &f : frames)
      for (auto &d : f.descs) all.push_back(&d);
    if (all.empty()) return;
    nodes.clear();
    n_words = 0;
    build_level(all, 0);
    trained = true;
    word_df.assign(n_words, 0);
    inverted.assign(n_words, {});
    for (size_t fi = 0; fi < frames.size(); fi++) index_frame((int)fi);
  }

  void index_frame(int fi) {
    compute_bow(frames[fi]);
    for (auto &kv : frames[fi].bow) {
      word_df[kv.first]++;
      inverted[kv.first].push_back(fi);
    }
  }

  // ---- API --------------------------------------------------------------
  void insert(long id, const uint8_t *desc, int n) {
    frames.emplace_back();
    Frame &f = frames.back();
    f.id = id;
    f.descs.resize(n);
    std::memcpy(f.descs.data(), desc, (size_t)n * 32);
    id2idx[id] = (int)frames.size() - 1;
    n_descs += n;
    if (!trained && n_descs >= train_threshold) train();
    else if (trained) index_frame((int)frames.size() - 1);
  }

  int query(long id, int radius, int topk, long *out_ids, float *out_scores) {
    if (!trained) {
      if (n_descs < train_threshold / 4) return 0;
      train();
    }
    auto it = id2idx.find(id);
    if (it == id2idx.end()) return 0;
    const Frame &q = frames[it->second];
    const float nf = (float)frames.size();
    std::unordered_map<int, float> score;
    for (auto &kv : q.bow) {
      const float idf = std::log(nf / std::max(1, word_df[kv.first]));
      const float wq = kv.second * idf;
      for (int fi : inverted[kv.first]) {
        const Frame &f = frames[fi];
        if (std::labs(f.id - id) < radius) continue;
        auto fit = f.bow.find(kv.first);
        if (fit == f.bow.end()) continue;
        // L1 similarity contribution (DBoW2 style)
        score[fi] += std::fabs(wq) + std::fabs(fit->second * idf) -
                     std::fabs(wq - fit->second * idf);
      }
    }
    std::vector<std::pair<float, int>> ranked;
    for (auto &kv : score) ranked.push_back({kv.second, kv.first});
    std::sort(ranked.rbegin(), ranked.rend());
    int out = 0;
    for (auto &pr : ranked) {
      if (out >= topk) break;
      out_ids[out] = frames[pr.second].id;
      out_scores[out] = pr.first * 0.5f;
      out++;
    }
    return out;
  }

  int match_pair(long i, long j, int max_dist, int *out_pairs, int cap) {
    auto ii = id2idx.find(i), jj = id2idx.find(j);
    if (ii == id2idx.end() || jj == id2idx.end()) return 0;
    const auto &da = frames[ii->second].descs;
    const auto &db = frames[jj->second].descs;
    int out = 0;
    for (size_t a = 0; a < da.size() && out < cap; a++) {
      int best = -1, bd = 1 << 30, bd2 = 1 << 30;
      for (size_t b = 0; b < db.size(); b++) {
        int d = hamming(da[a], db[b]);
        if (d < bd) { bd2 = bd; bd = d; best = (int)b; }
        else if (d < bd2) bd2 = d;
      }
      // Lowe ratio in Hamming space + absolute gate
      if (best >= 0 && bd < max_dist && bd * 10 < bd2 * 8) {
        out_pairs[2 * out] = (int)a;
        out_pairs[2 * out + 1] = best;
        out++;
      }
    }
    return out;
  }
};

}  // namespace

extern "C" {

void *retr_create(int K, int L, long train_threshold) {
  auto *r = new Retrieval();
  if (K > 0) r->K = std::min(K, 16);
  if (L > 0) r->L = L;
  if (train_threshold > 0) r->train_threshold = (size_t)train_threshold;
  return r;
}

void retr_destroy(void *h) { delete (Retrieval *)h; }

void retr_insert(void *h, long id, const uint8_t *desc, int n) {
  ((Retrieval *)h)->insert(id, desc, n);
}

int retr_query(void *h, long id, int radius, int topk, long *out_ids,
               float *out_scores) {
  return ((Retrieval *)h)->query(id, radius, topk, out_ids, out_scores);
}

int retr_match(void *h, long i, long j, int max_dist, int *out_pairs, int cap) {
  return ((Retrieval *)h)->match_pair(i, j, max_dist, out_pairs, cap);
}

int retr_num_frames(void *h) { return (int)((Retrieval *)h)->frames.size(); }
int retr_trained(void *h) { return ((Retrieval *)h)->trained ? 1 : 0; }
}
